"""Fused gather -> radial MLP -> CG tensor product -> scatter convolution.

Counterpart of ``nequip_tpu/ops/pallas/tp_scatter.py``.  Three hand-written
CUDA kernels (``nequip_tpu_torch/csrc/``) carry the energy+forces path:

* K1 ``conv_fwd``: the fused forward, ``[N, mid_dim]`` messages summed per
  destination node, with the radial MLP computed in-kernel;
* K2 ``conv_bwd``: its first-order backward, per-edge ``dx``, ``dsh`` and
  ``demb`` (the inputs of the force computation);
* K3 ``scatter_rows``: the row scatter-sum of K2's per-edge ``dx`` onto the
  source nodes.

Each wrapper runs its plain PyTorch twin (``*_plain``) when its tensors lie
on the CPU, launches its kernel when they lie on a CUDA device, and raises
for any other device.  Each counts its kernel launches in ``.launches``.

Edge stream contract (built once per neighbour list by
``relayout_edge_stream``): the real edges come first, sorted by destination
(stable), masked and padding edges after them.  ``EdgeLayout`` holds the
destination CSR row pointers over the real edges and the stable
source-sorted permutation with its row pointers; masked edges sit in no
segment, so nothing reads them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ...data import _keys
from ...data._key_registry import get_field_type
from ..cg import cg_component_normalized
from ..tensor_product import TensorProduct
from . import build

LAYOUT_KEY = _keys.EDGE_LAYOUT_KEY_PREFIX + "csr"
_MAX_YDIM = 9  # kMaxYDim in csrc/tp_common.cuh


# ---------------------------------------------------------------------------
# static plan: the TP's CG terms as small tables the kernels loop over
# ---------------------------------------------------------------------------
class TPPlan:
    """Port of ``_TPPlan``: per-path offsets and nonzero CG terms of a conv
    ``uvu`` tensor product, plus the term tables of the CUDA kernels."""

    def __init__(self, tp: TensorProduct):
        self.tp = tp
        self.dim_in = tp.irreps_in1.dim
        self.sh_dim = tp.irreps_in2.dim
        self.mid_dim = tp.irreps_out.dim
        self.weight_numel = tp.weight_numel
        sl1, sl2, sl3 = tp.irreps_in1.slices(), tp.irreps_in2.slices(), tp.irreps_out.slices()

        self.paths = []
        for idx, ins in enumerate(tp.instructions):
            mi1, mi2, mi3 = tp.irreps_in1[ins.i_in1], tp.irreps_in2[ins.i_in2], tp.irreps_out[ins.i_out]
            if ins.mode != "uvu" or not ins.has_weight or mi2.mul != 1 or mi3.mul != mi1.mul:
                raise ValueError("the fused kernels support the weighted conv 'uvu' TP with SH multiplicity 1")
            cg = cg_component_normalized(mi1.ir.l, mi2.ir.l, mi3.ir.l)
            terms = [
                (m1, m2, m3, float(cg[m1, m2, m3]) * ins.path_weight)
                for m1 in range(mi1.ir.dim)
                for m2 in range(mi2.ir.dim)
                for m3 in range(mi3.ir.dim)
                if abs(cg[m1, m2, m3]) > 1e-12
            ]
            self.paths.append(
                dict(
                    x_off=sl1[ins.i_in1].start,
                    y_off=sl2[ins.i_in2].start,
                    y_dim=mi2.ir.dim,
                    out_off=sl3[ins.i_out].start,
                    out_chunk=ins.i_out,
                    x_chunk=ins.i_in1,
                    mul=mi1.mul,
                    dim3=mi3.ir.dim,
                    w_off=tp._weight_slices[idx].start,
                    terms=terms,
                )
            )
        if len({p["out_chunk"] for p in self.paths}) != len(self.paths):
            raise ValueError("the fused kernels need one path per output chunk")
        if max(p["y_dim"] for p in self.paths) > _MAX_YDIM:
            raise ValueError(f"SH chunks wider than {_MAX_YDIM} (l > 4) are not supported")
        self._tables = self._build_tables()
        self._device_tables: Dict[Tuple[torch.device, torch.dtype], Dict[str, torch.Tensor]] = {}

    def _build_tables(self) -> Dict[str, np.ndarray]:
        # K1: one group per output row (path, m3)
        fwd_groups, fwd_terms, fwd_coef = [], [], []
        fwd_col = np.full(self.mid_dim, -1, dtype=np.int32)
        for p in self.paths:
            for m3 in range(p["dim3"]):
                row = p["out_off"] + m3 * p["mul"]
                t0 = len(fwd_coef)
                for m1, m2, mm3, c in p["terms"]:
                    if mm3 == m3:
                        fwd_terms.append((p["x_off"] + m1 * p["mul"], p["y_off"] + m2))
                        fwd_coef.append(c)
                fwd_col[row : row + p["mul"]] = len(fwd_groups)
                fwd_groups.append((row, p["w_off"], t0, len(fwd_coef)))
        # K2 dx: one group per input row (x chunk, m1)
        irreps_in = self.tp.irreps_in1
        dx_groups, dx_terms, dx_coef = [], [], []
        dx_col = np.full(self.dim_in, -1, dtype=np.int32)
        for i1, (sl, mi) in enumerate(zip(irreps_in.slices(), irreps_in)):
            for m1 in range(mi.ir.dim):
                row = sl.start + m1 * mi.mul
                t0 = len(dx_coef)
                for p in self.paths:
                    if p["x_chunk"] != i1:
                        continue
                    for mm1, m2, m3, c in p["terms"]:
                        if mm1 == m1:
                            dx_terms.append((p["out_off"] + m3 * p["mul"], p["y_off"] + m2, p["w_off"]))
                            dx_coef.append(c)
                dx_col[row : row + mi.mul] = len(dx_groups)
                dx_groups.append((row, 0, t0, len(dx_coef)))
        # K2 dW/dsh: one group per path
        paths, path_terms, path_coef = [], [], []
        for p in self.paths:
            t0 = len(path_coef)
            for m1, m2, m3, c in p["terms"]:
                path_terms.append((p["x_off"] + m1 * p["mul"], p["out_off"] + m3 * p["mul"], m2))
                path_coef.append(c)
            paths.append((p["w_off"], p["mul"], p["y_off"], p["y_dim"], t0, len(path_coef)))
        assert (fwd_col >= 0).all() and (dx_col >= 0).all()
        i32 = lambda a, w: np.asarray(a, dtype=np.int32).reshape(-1, w)
        return dict(
            fwd_groups=i32(fwd_groups, 4), fwd_terms=i32(fwd_terms, 2),
            fwd_coef=np.asarray(fwd_coef), fwd_col=fwd_col,
            dx_groups=i32(dx_groups, 4), dx_terms=i32(dx_terms, 3),
            dx_coef=np.asarray(dx_coef), dx_col=dx_col,
            paths=i32(paths, 6), path_terms=i32(path_terms, 3),
            path_coef=np.asarray(path_coef),
        )

    def device_tables(self, device: torch.device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        key = (device, dtype)
        if key not in self._device_tables:
            self._device_tables[key] = {
                k: torch.as_tensor(v, dtype=dtype if v.dtype.kind == "f" else torch.int32, device=device)
                for k, v in self._tables.items()
            }
        return self._device_tables[key]


# ---------------------------------------------------------------------------
# edge stream in kernel order
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class EdgeLayout:
    edge_src: torch.Tensor  # int32 [E], source of every slot (kernel order)
    dst_ptr: torch.Tensor   # int32 [N+1], CSR over the real edges
    src_perm: torch.Tensor  # int32 [n_real], real slots sorted (stably) by source
    src_ptr: torch.Tensor   # int32 [N+1], CSR of src_perm
    n_real: int             # real edges: slots [0, n_real) of the stream

    @property
    def num_nodes(self) -> int:
        return self.dst_ptr.shape[0] - 1


def _ptr(keys: torch.Tensor, num_nodes: int) -> torch.Tensor:
    counts = torch.bincount(keys, minlength=num_nodes)
    return F.pad(torch.cumsum(counts, 0), (1, 0)).to(torch.int32)


def build_edge_layout(edge_index: torch.Tensor, edge_mask: torch.Tensor, num_nodes: int) -> EdgeLayout:
    """CSR layout of a stream already in kernel order (see module docstring)."""
    dst, src = edge_index[0], edge_index[1]
    n_real = int(edge_mask.sum())
    real_dst = dst[:n_real]
    if not bool(edge_mask[:n_real].all()) or bool((real_dst[1:] < real_dst[:-1]).any()):
        raise ValueError("edge stream is not in kernel order: use relayout_edge_stream")
    real_src = src[:n_real]
    return EdgeLayout(
        edge_src=src.to(torch.int32).contiguous(),
        dst_ptr=_ptr(real_dst, num_nodes),
        src_perm=torch.argsort(real_src, stable=True).to(torch.int32),
        src_ptr=_ptr(real_src, num_nodes),
        n_real=n_real,
    )


def relayout_edge_stream(data: dict) -> dict:
    """Permute every per-edge field into kernel order and attach the layout.

    Counterpart of the JAX ``relayout_edge_stream``: per-edge tensors
    computed downstream (SH, radial embedding) are then born in kernel
    order.  No-op when the layout is already attached.
    """
    if LAYOUT_KEY in data:
        return data
    edge_index = data[_keys.EDGE_INDEX_KEY]
    num_nodes = data[_keys.POSITIONS_KEY].shape[0]
    n_edges = edge_index.shape[1]
    mask = data.get(_keys.EDGE_MASK_KEY)
    if mask is None:
        mask = torch.ones(n_edges, dtype=torch.bool, device=edge_index.device)
    key = torch.where(mask, edge_index[0], torch.full_like(edge_index[0], num_nodes))
    order = torch.argsort(key, stable=True)
    out = dict(data)
    out[_keys.EDGE_INDEX_KEY] = edge_index[:, order]
    out[_keys.EDGE_MASK_KEY] = mask[order]
    for k, v in data.items():
        if (
            k not in (_keys.EDGE_INDEX_KEY, _keys.EDGE_MASK_KEY)
            and isinstance(v, torch.Tensor)
            and get_field_type(k, error_on_unregistered=False) == "edge"
        ):
            out[k] = v[order]
    out[LAYOUT_KEY] = build_edge_layout(out[_keys.EDGE_INDEX_KEY], out[_keys.EDGE_MASK_KEY], num_nodes)
    return out


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------
def radial_weights(emb: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   alpha0: float, alpha1: float) -> torch.Tensor:
    """The depth-1 bias-free silu radial MLP (``ops/mlp.py`` semantics)."""
    return F.silu(emb @ (w1 * alpha0)) @ (w2 * alpha1)


def _segment_rows(ptr: torch.Tensor) -> torch.Tensor:
    """Row id of every CSR slot."""
    n = ptr.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n, device=ptr.device), (ptr[1:] - ptr[:-1]).long())


def conv_fwd_plain(plan, x, sh, emb, w1, w2, alpha0, alpha1, layout: EdgeLayout):
    n_real = layout.n_real
    dst = _segment_rows(layout.dst_ptr)
    src = layout.edge_src[:n_real].long()
    w = radial_weights(emb[:n_real], w1, w2, alpha0, alpha1)
    msg = plan.tp(x[src], sh[:n_real], w)
    return x.new_zeros(layout.num_nodes, plan.mid_dim).index_add_(0, dst, msg)


def conv_bwd_plain(plan, x, sh, emb, w1, w2, alpha0, alpha1, layout: EdgeLayout, g):
    n_real = layout.n_real
    dst = _segment_rows(layout.dst_ptr)
    src = layout.edge_src[:n_real].long()
    with torch.enable_grad():
        xs = x[src].detach().requires_grad_(True)
        ys = sh[:n_real].detach().requires_grad_(True)
        es = emb[:n_real].detach().requires_grad_(True)
        msg = plan.tp(xs, ys, radial_weights(es, w1.detach(), w2.detach(), alpha0, alpha1))
        dxs, dys, des = torch.autograd.grad(msg, (xs, ys, es), g[dst])
    dx_edge = x.new_zeros(sh.shape[0], plan.dim_in)
    dx_edge[:n_real] = dxs
    dsh = torch.zeros_like(sh)
    dsh[:n_real] = dys
    demb = torch.zeros_like(emb)
    demb[:n_real] = des
    return dx_edge, dsh, demb


def scatter_rows_plain(values, perm, ptr):
    rows = _segment_rows(ptr)
    out = values.new_zeros((ptr.shape[0] - 1,) + tuple(values.shape[1:]))
    return out.index_add_(0, rows, values[perm.long()])


# ---------------------------------------------------------------------------
# kernel wrappers: CPU -> plain twin, CUDA -> kernel, anything else raises
# ---------------------------------------------------------------------------
def _route(name: str, *tensors: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the plain twin; checks the inputs."""
    dev = tensors[0].device
    dtype = tensors[0].dtype
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: inputs must share one device and dtype")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return True


def _check_layout(layout: EdgeLayout, device: torch.device) -> None:
    for t in (layout.edge_src, layout.dst_ptr, layout.src_perm, layout.src_ptr):
        if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("edge layout tensors must be contiguous int32 on the kernel's device")


def conv_fwd(plan: TPPlan, x, sh, emb, w1, w2, alpha0: float, alpha1: float, layout: EdgeLayout):
    """K1: ``[N, mid_dim]`` fused conv messages (see ``csrc/conv_fwd.cu``)."""
    if not _route("conv_fwd", x, sh, emb, w1, w2):
        return conv_fwd_plain(plan, x, sh, emb, w1, w2, alpha0, alpha1, layout)
    _check_layout(layout, x.device)
    n_emb, hidden = w1.shape
    tab = plan.device_tables(x.device, x.dtype)
    out = torch.empty(layout.num_nodes, plan.mid_dim, dtype=x.dtype, device=x.device)
    err = build.entry_point("nequip_conv_fwd", x.dtype)(
        x.data_ptr(), sh.data_ptr(), emb.data_ptr(), w1.data_ptr(), w2.data_ptr(),
        layout.edge_src.data_ptr(), layout.dst_ptr.data_ptr(),
        tab["fwd_groups"].data_ptr(), tab["fwd_terms"].data_ptr(),
        tab["fwd_coef"].data_ptr(), tab["fwd_col"].data_ptr(), out.data_ptr(),
        layout.num_nodes, plan.dim_in, plan.sh_dim, n_emb, hidden, plan.weight_numel,
        plan.mid_dim, alpha0, alpha1, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "conv_fwd")
    conv_fwd.launches += 1
    return out


def conv_bwd(plan: TPPlan, x, sh, emb, w1, w2, alpha0: float, alpha1: float, layout: EdgeLayout, g):
    """K2: per-edge ``(dx [E, dim_in], dsh [E, sh_dim], demb [E, n_emb])``
    of K1 for the node cotangent ``g`` (see ``csrc/conv_bwd.cu``); zero rows
    at masked slots."""
    if not _route("conv_bwd", x, sh, emb, w1, w2, g):
        return conv_bwd_plain(plan, x, sh, emb, w1, w2, alpha0, alpha1, layout, g)
    _check_layout(layout, x.device)
    n_emb, hidden = w1.shape
    tab = plan.device_tables(x.device, x.dtype)
    w2t = w2.t().contiguous()
    dx_edge = torch.empty(sh.shape[0], plan.dim_in, dtype=x.dtype, device=x.device)
    dx_edge[layout.n_real :].zero_()  # the kernel writes the real slots only
    dsh = torch.zeros_like(sh)
    demb = torch.zeros_like(emb)
    err = build.entry_point("nequip_conv_bwd", x.dtype)(
        x.data_ptr(), sh.data_ptr(), emb.data_ptr(), w1.data_ptr(), w2.data_ptr(),
        w2t.data_ptr(), layout.edge_src.data_ptr(), layout.dst_ptr.data_ptr(), g.data_ptr(),
        tab["dx_groups"].data_ptr(), tab["dx_terms"].data_ptr(), tab["dx_coef"].data_ptr(),
        tab["dx_col"].data_ptr(), tab["paths"].data_ptr(), tab["path_terms"].data_ptr(),
        tab["path_coef"].data_ptr(), dx_edge.data_ptr(), dsh.data_ptr(), demb.data_ptr(),
        len(plan.paths), layout.num_nodes, plan.dim_in, plan.sh_dim, n_emb, hidden,
        plan.weight_numel, plan.mid_dim, alpha0, alpha1,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "conv_bwd")
    conv_bwd.launches += 1
    return dx_edge, dsh, demb


def scatter_rows(values, perm, ptr):
    """K3: ``out[n] = sum_{j in ptr[n]:ptr[n+1]} values[perm[j]]`` (see
    ``csrc/scatter_rows.cu``)."""
    if not _route("scatter_rows", values):
        return scatter_rows_plain(values, perm, ptr)
    for t in (perm, ptr):
        if t.device != values.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("scatter_rows: perm and ptr must be contiguous int32 on the values' device")
    if values.dim() != 2:
        raise ValueError("scatter_rows: values must be [M, D]")
    n_rows = ptr.shape[0] - 1
    out = torch.empty(n_rows, values.shape[1], dtype=values.dtype, device=values.device)
    err = build.entry_point("nequip_scatter_rows", values.dtype)(
        values.data_ptr(), perm.data_ptr(), ptr.data_ptr(), out.data_ptr(),
        n_rows, values.shape[1], torch.cuda.current_stream(values.device).cuda_stream,
    )
    build.check(err, "scatter_rows")
    scatter_rows.launches += 1
    return out


conv_fwd.launches = 0
conv_bwd.launches = 0
scatter_rows.launches = 0
KERNELS = {"conv_fwd": conv_fwd, "conv_bwd": conv_bwd, "scatter_rows": scatter_rows}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


# ---------------------------------------------------------------------------
# autograd: forward K1; backward K2 then K3
# ---------------------------------------------------------------------------
class FusedConv(torch.autograd.Function):
    """``out = scatter_dst(TP(x[src], sh, MLP(emb; w1, w2)))`` with the
    kernels as forward and backward.  Gradients flow to ``x``, ``sh`` and
    ``emb`` (hence to the edge vectors and positions); ``w1``/``w2``
    gradients need a cross-block reduction K2 does not do, so asking for
    them raises."""

    @staticmethod
    def forward(ctx, x, sh, emb, w1, w2, plan, alpha0, alpha1, layout):
        ctx.plan, ctx.alphas, ctx.layout = plan, (alpha0, alpha1), layout
        ctx.save_for_backward(x, sh, emb, w1, w2)
        return conv_fwd(plan, x, sh, emb, w1, w2, alpha0, alpha1, layout)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        if ctx.needs_input_grad[3] or ctx.needs_input_grad[4]:
            raise NotImplementedError(
                "FusedConv computes no radial-MLP weight gradients: dW1/dW2 need a "
                "cross-block reduction that comes with the port of training (K2's "
                "training variant, then K4-K7); freeze the weights for inference"
            )
        x, sh, emb, w1, w2 = ctx.saved_tensors
        layout = ctx.layout
        dx_edge, dsh, demb = conv_bwd(ctx.plan, x, sh, emb, w1, w2, *ctx.alphas, layout, g.contiguous())
        dx = scatter_rows(dx_edge, layout.src_perm, layout.src_ptr) if ctx.needs_input_grad[0] else None
        return dx, dsh, demb, None, None, None, None, None, None


def fused_tp_scatter_mlp(plan: TPPlan, x, sh, emb, w1, w2, alpha0: float, alpha1: float,
                         layout: EdgeLayout) -> torch.Tensor:
    """Fully fused conv; ``w1``/``w2`` are the radial MLP's ``w0``/``w1``."""
    return FusedConv.apply(x, sh, emb, w1, w2, plan, alpha0, alpha1, layout)
