"""Fused gather -> radial MLP -> CG tensor product -> scatter convolution.

Counterpart of ``nequip_tpu/ops/pallas/tp_scatter.py``.  Hand-written CUDA
kernels (``nequip_tpu_torch/csrc/``) carry the energy+forces path and its
force-loss training:

* K1 ``conv_fwd``: the fused forward, ``[N, mid_dim]`` messages summed per
  destination node, with the radial MLP computed in-kernel;
* K2 ``conv_bwd``: its first-order backward, per-edge ``dx``, ``dsh`` and
  ``demb`` (the inputs of the force computation), and ``conv_bwd_train``,
  its training variant, which also returns the radial-MLP weight gradients
  ``dw1``/``dw2`` through ``dw_reduce``, a deterministic two-pass reduction
  over the edges;
* K3 ``scatter_rows``: the row scatter-sum of per-edge ``dx`` onto the
  source nodes;
* K4 ``tri_fwd`` and K5 ``tri_bwd``: the trilinear family
  ``F(x, y, w) = scatter_dst(TP(x[src], y, w))`` with given per-edge
  weights, and its per-edge VJP; K4-acc ``tri_fwd(acc=...)`` (counted as
  ``tri_fwd_acc``) adds one edge slice onto ``[N, mid_dim]`` accumulators
  in place;
* K6 ``jvp_fwd`` and K7 ``jvp_bwd``: the fr dual sweep, ``F`` and its
  three tangent terms in one pass (optionally onto accumulators), and
  its per-edge VJP for both node cotangents.

Each wrapper runs its plain PyTorch twin (``*_plain``) when its tensors lie
on the CPU, launches its kernel when they lie on a CUDA device, and raises
for any other device.  Each counts its kernel launches in ``.launches``.

bfloat16 (the fast mode): K1, K2 (both variants), K3 and the
trilinear kernels K4/K4-acc, K5, K6 and K7 take bf16 operands and return
bf16 outputs, with every sum in float32 (``acc_dtype``: their term tables
and the carry rows of K1, K4 and K6 are float32).  Their plain twins, given
bf16, compute in float32 and round where the kernels round (stated in each
kernel's header): K1 rounds ``w`` and each output, K2 ``h``, ``w`` and each
output, K3, K4, K5, K6 and K7 each output.  K1, K4 and K6 sum over edges in
compensated float32 (hi + lo), so that an output does not depend on how the
edge stream falls into tiles; their twins sum in float64.  K4-acc and
K6-acc add onto float32 accumulators (``acc_dtype``), which the edge-sliced
convolutions round to bf16 once, after the last slice.  K2's training
variant stores its per-edge dW factors in bf16, rounded once, and the dW
reduction sums them in float32 into float32 ``dw1``/``dw2``.  On the card a
kernel then differs from its twin only by the order of its sums.

Serving (frozen radial-MLP weights) runs K1, K2's inference variant and K3
as registered ops, ``torch.ops.nequip_torch.{conv_fwd, conv_bwd,
scatter_rows}``, and on K4's route (a radial MLP K1 does not take), where
the real-edge count stays on the device (a traced program), K4 and K5's
first-order backward as ``nequip_torch.{tri_fwd, tri_bwd}``, whose
arguments are tensors and numbers only (the plan's
tables, the layout's four tensors): a tracer (``make_fx``, ``torch.export``)
records them as single nodes, and an exported program calls them.  Their
CUDA kernels are the launches the wrappers make; their CPU kernels are the
plain twins, with the TP computed from K1's tables (``_TablePlan``); K1's
backward is K2's inference variant, then K3.  Inside the ops the real-edge
count is read on the device (``dst_ptr[N]``, by the kernels) and never on
the host, so a trace holds no value of the data.

Autograd (as ``_make_fused_mlp`` and ``_make_fused_uncached`` in JAX):
``FusedConv`` (K1) has the backward ``FusedConvBwd`` (K2, then K3), whose
own backward is the composition of the radial MLP with the trilinear
family; ``TriConv`` (K4) and ``TriConvBwd`` (K5, then K3) are written in
terms of each other, so the family is closed under differentiation to all
orders and a force loss trains through the kernels (reverse over reverse).
fr training (reverse over forward) runs the first-order ``ChunkedConv``
(K4/K4-acc, backward K5 + K3) and ``ChunkedJvpConv`` (K6, backward K7 +
K3) over the slices of ``EdgeLayout.slices(C)``.

Edge stream contract (built once per neighbour list by
``relayout_edge_stream``): the real edges come first, sorted by destination
(stable), masked and padding edges after them.  ``EdgeLayout`` holds the
destination CSR row pointers over the real edges and the stable
source-sorted permutation with its row pointers; masked edges sit in no
segment, so nothing reads them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ...data import _keys
from ...data._key_registry import get_field_type
from ..cg import cg_component_normalized
from ..tensor_product import TensorProduct
from . import build

LAYOUT_KEY = _keys.EDGE_LAYOUT_KEY_PREFIX + "csr"
_MAX_YDIM = 9  # kMaxYDim in csrc/tp_common.cuh
# dw_reduce's f32 block tiles (csrc/dw_reduce.cu), which f64 shares: (rows,
# columns, resident blocks per SM), the narrow one for P <= 8 (dW1), the wide
# one otherwise (dW2)
_DW_NARROW, _DW_WIDE = (8, 128, 3), (128, 96, 2)
# bf16's tensor-core tiles, the same way: the narrow one, and the wide one's
# rows, widest column tile and column step (_dw_tile); chunks are whole
# slabs of 64 edges, and at most _DW_BF16_MAX_CHUNK edges long: the tensor
# cores' float32 sums round at each k16 step, so an accumulator's error
# grows with the edges it sums (_dw_split)
_DW_BF16_NARROW, _DW_BF16_WIDE = (8, 128, 1), (128, 352, 32)
_DW_BF16_SLAB, _DW_BF16_MAX_CHUNK = 64, 4096
_DW_SMS = 132  # SMs of an H100 SXM: the split fills one wave of them
_DW_MIN_CHUNK = 64  # fewest edges in a chunk of dw_reduce


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
        # K2 dW/dsh: one group per path, its terms sorted (stably) by m2, so
        # that A[p, m2] is one run of terms (conv_bwd.cu); the kernels that
        # sum A[p, m2] term by term get the same sums in the same order
        paths, path_terms, path_coef = [], [], []
        for p in self.paths:
            t0 = len(path_coef)
            for m1, m2, m3, c in sorted(p["terms"], key=lambda term: term[1]):
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
        """The tables on ``device``, floats in ``dtype``, in ``TABLE_NAMES``
        order (the registered ops take them in that order)."""
        key = (device, dtype)
        if key not in self._device_tables:
            self._device_tables[key] = {
                k: torch.as_tensor(self._tables[k], dtype=dtype if self._tables[k].dtype.kind == "f" else torch.int32,
                                   device=device)
                for k in TABLE_NAMES
            }
        return self._device_tables[key]


TABLE_NAMES = ("fwd_groups", "fwd_terms", "fwd_coef", "fwd_col", "dx_groups", "dx_terms", "dx_coef", "dx_col",
               "paths", "path_terms", "path_coef")


# ---------------------------------------------------------------------------
# edge stream in kernel order
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class EdgeLayout:
    edge_src: torch.Tensor  # int32 [E], source of every slot (kernel order)
    dst_ptr: torch.Tensor   # int32 [N+1], CSR over the real edges
    src_perm: torch.Tensor  # int32 [n_real] (or longer: entries past n_real unread), real slots sorted (stably) by source
    src_ptr: torch.Tensor   # int32 [N+1], CSR of src_perm
    n_real: Optional[int]   # real edges: slots [0, n_real) of the stream; None where it stays on the device
    _slices: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def num_nodes(self) -> int:
        return self.dst_ptr.shape[0] - 1

    def slices(self, n_chunks: int) -> Tuple["EdgeSlice", ...]:
        """The slice table of the edge-chunked fr sweep (``edge_slices``),
        built once per ``n_chunks`` and kept with the layout."""
        if n_chunks not in self._slices:
            self._slices[n_chunks] = edge_slices(self, n_chunks)
        return self._slices[n_chunks]


class EdgeSlice(NamedTuple):
    """Real edges ``[start, stop)`` of the stream and their own layout:
    ``edge_src`` a view of the slice, ``dst_ptr`` the destination CSR clipped
    to the slice (relative to ``start``), and the slice's stable source CSR.
    Per-edge operands of a slice are the rows ``[start, stop)``."""

    start: int
    stop: int
    layout: EdgeLayout


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


def check_edge_chunks(n_chunks: int, n_real: int) -> None:
    if not (isinstance(n_chunks, int) and 2 <= n_chunks <= n_real):
        raise ValueError(
            f"fr_edge_chunks={n_chunks!r}: the edge stream of {n_real} real edges splits into "
            f"2 to {n_real} slices (0 turns chunking off)"
        )


def edge_slices(layout: EdgeLayout, n_chunks: int, bounds=None) -> Tuple[EdgeSlice, ...]:
    """``n_chunks`` contiguous, near-equal ranges of the real, dst-sorted
    edges (counterpart of the ``stk`` dict of the JAX ``chunked_jvp_conv``),
    or the ranges between the given ``bounds`` (``0 = b_0 < ... < b_C =
    n_real``).  The CSR stream splits at any edge: a destination whose
    segment crosses a boundary appears in both slices, and the accumulating
    kernels add its second part onto the first."""
    n = layout.n_real
    check_edge_chunks(n_chunks, n)
    if bounds is None:
        bounds = [s * n // n_chunks for s in range(n_chunks + 1)]
    bounds = [int(b) for b in bounds]
    if len(bounds) != n_chunks + 1 or bounds[0] != 0 or bounds[-1] != n or any(
            a >= b for a, b in zip(bounds, bounds[1:])):
        raise ValueError(f"slice bounds must rise strictly from 0 to {n}, {n_chunks} slices: {bounds}")
    out = []
    for lo, hi in zip(bounds, bounds[1:]):
        src = layout.edge_src[lo:hi]
        out.append(EdgeSlice(lo, hi, EdgeLayout(
            edge_src=src,
            dst_ptr=(layout.dst_ptr.clamp(lo, hi) - lo).to(torch.int32),
            src_perm=torch.argsort(src, stable=True).to(torch.int32),
            src_ptr=_ptr(src.long(), layout.num_nodes),
            n_real=hi - lo,
        )))
    return tuple(out)


def _num_nodes(data: dict) -> int:
    key = _keys.POSITIONS_KEY if _keys.POSITIONS_KEY in data else _keys.ATOM_TYPE_KEY
    return data[key].shape[0]


def _edge_mask(data: dict) -> torch.Tensor:
    mask = data.get(_keys.EDGE_MASK_KEY)
    if mask is None:
        edge_index = data[_keys.EDGE_INDEX_KEY]
        mask = torch.ones(edge_index.shape[1], dtype=torch.bool, device=edge_index.device)
    return mask


def kernel_order(data: dict) -> torch.Tensor:
    """The permutation ``relayout_edge_stream`` applies to the edges: real
    edges first, by destination (stable), masked edges after them."""
    edge_index = data[_keys.EDGE_INDEX_KEY]
    key = torch.where(_edge_mask(data), edge_index[0], torch.full_like(edge_index[0], _num_nodes(data)))
    return torch.argsort(key, stable=True)


def to_caller_order(values: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Per-edge ``values`` in kernel order back in the order of the stream
    that ``kernel_order`` was taken of."""
    return values.index_select(0, torch.argsort(order))  # a gather: deterministic on the card


def relayout_edge_stream(data: dict, order: Optional[torch.Tensor] = None) -> dict:
    """Permute every per-edge field into kernel order and attach the layout.

    Counterpart of the JAX ``relayout_edge_stream``: per-edge tensors
    computed downstream (SH, radial embedding) are then born in kernel
    order.  No-op when the layout is already attached.  ``order`` is the
    stream's ``kernel_order`` where the caller has it already.
    """
    if LAYOUT_KEY in data:
        return data
    edge_index = data[_keys.EDGE_INDEX_KEY]
    num_nodes = _num_nodes(data)
    mask = _edge_mask(data)
    if order is None:
        order = kernel_order(data)
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


# the layout as four tensors of fixed shape, the inputs of an exported program
LAYOUT_TENSORS = ("edge_src", "dst_ptr", "src_perm", "src_ptr")
LAYOUT_FIELDS = tuple(f"{LAYOUT_KEY}.{name}" for name in LAYOUT_TENSORS)


def layout_fields(layout: EdgeLayout) -> Dict[str, torch.Tensor]:
    """The layout's tensors under ``LAYOUT_FIELDS``, ``src_perm`` padded
    with zeros to the stream's length (the kernels read none of the pad)."""
    n_pad = layout.edge_src.shape[0] - layout.src_perm.shape[0]
    return dict(zip(LAYOUT_FIELDS, (layout.edge_src, layout.dst_ptr, F.pad(layout.src_perm, (0, n_pad)),
                                    layout.src_ptr)))


def _csr_ptr(sorted_keys: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Row pointers of keys sorted ascending (keys == ``num_nodes`` in no row)."""
    return torch.searchsorted(sorted_keys, torch.arange(num_nodes + 1, device=sorted_keys.device,
                                                        dtype=sorted_keys.dtype))


def fill_edge_layout_(layout: EdgeLayout, edge_index: torch.Tensor, edge_mask: torch.Tensor) -> EdgeLayout:
    """Refill ``layout``'s four tensors in place from a stream already in
    kernel order (real edges first, sorted by destination; ``src_perm`` of
    the stream's length) and return a layout over them with ``n_real``
    None: the kernels read the real-edge count from ``dst_ptr[N]``.  Sorts,
    searches and copies on the stream's device only, with no read-back to
    the host, so a CUDA graph can capture it (the MD driver's device
    rebuild).  ``src_perm``'s entries past the real edges are the masked
    slots, which nothing reads.  Equal to ``build_edge_layout`` on the
    same stream, except that it does not check the order (that would read
    back)."""
    n = layout.num_nodes
    dst, src = edge_index[0], edge_index[1]
    sentinel = torch.full_like(dst, n)
    layout.edge_src.copy_(src)
    layout.dst_ptr.copy_(_csr_ptr(torch.where(edge_mask, dst, sentinel), n))
    key = torch.where(edge_mask, src, sentinel)
    perm = torch.argsort(key, stable=True)
    layout.src_perm.copy_(perm)
    layout.src_ptr.copy_(_csr_ptr(key[perm], n))
    return EdgeLayout(layout.edge_src, layout.dst_ptr, layout.src_perm, layout.src_ptr, n_real=None)


def layout_from_fields(data: dict) -> EdgeLayout:
    """The layout over the tensors of ``layout_fields``; its real-edge count
    stays on the device (``n_real`` None)."""
    return EdgeLayout(*(data[f] for f in LAYOUT_FIELDS), n_real=None)


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------
def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the kernels sum in for operands of ``dtype``: float32 for
    bfloat16, else ``dtype`` (the JAX ``_acc_dtype``)."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _wide(*ts: torch.Tensor):
    """The tensors in their sum dtype (``acc_dtype``): bfloat16 widened to
    float32, the others as they are."""
    return tuple(t.to(acc_dtype(t.dtype)) for t in ts)


def _round_as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype``'s precision, kept in its own dtype: a
    rounding point of a bf16 kernel (the identity for f32 and f64)."""
    return t.to(dtype).to(t.dtype) if dtype == torch.bfloat16 else t


def _bf16_nearest(t: torch.Tensor) -> torch.Tensor:
    """The bf16 nearest to each float64 value (ties to even).  torch's own
    cast goes through float32 and may round twice; here a float32 value on
    a bf16 tie is moved one float32 ulp toward the float64 value first."""
    f = t.float()
    tie = (f.view(torch.int32) & 0xFFFF) == 0x8000
    rest = t - f.double()
    toward = torch.where(rest > 0, torch.full_like(f, math.inf), torch.full_like(f, -math.inf))
    return torch.where(tie & (rest != 0), torch.nextafter(f, toward), f).to(torch.bfloat16)


def radial_weights(emb: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   alpha0: float, alpha1: float) -> torch.Tensor:
    """The depth-1 bias-free silu radial MLP (``ops/mlp.py`` semantics)."""
    return F.silu(emb @ (w1 * alpha0)) @ (w2 * alpha1)


def _segment_rows(ptr: torch.Tensor) -> torch.Tensor:
    """Row id of every CSR slot."""
    n = ptr.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n, device=ptr.device), (ptr[1:] - ptr[:-1]).long())


def conv_fwd_plain(plan, x, sh, emb, w1, w2, alpha0, alpha1, layout: EdgeLayout):
    """K1's twin; bf16 inputs run in float32 with ``w`` rounded to bf16, the
    messages summed in float64 (K1's compensated float32 sums agree with
    that to far below a bf16 ulp) and each output rounded once to the
    nearest bf16 (K1's rounding points)."""
    dtype = x.dtype
    x, sh, emb, w1, w2 = _wide(x, sh, emb, w1, w2)
    n_real = layout.n_real
    dst = _segment_rows(layout.dst_ptr)
    src = layout.edge_src[:n_real].long()
    w = _round_as(radial_weights(emb[:n_real], w1, w2, alpha0, alpha1), dtype)
    msg = plan.tp(x[src], sh[:n_real], w)
    if dtype == torch.bfloat16:
        out = torch.zeros(layout.num_nodes, plan.mid_dim, dtype=torch.float64, device=x.device)
        return _bf16_nearest(out.index_add_(0, dst, msg.double()))
    return x.new_zeros(layout.num_nodes, plan.mid_dim).index_add_(0, dst, msg)


def _conv_bwd_terms(plan, x, sh, emb, w1, w2, alpha0, alpha1, layout: EdgeLayout, g):
    """K2's arithmetic over the real edges in plain torch: the VJP of the
    radial MLP and of the TP written out (``_table_tp_vjp``), no autograd
    inside (the CPU kernel of a registered op runs it).  Returns ``(dx_edge,
    dsh, demb)`` and the per-edge factors ``(h, dW, dh_pre)`` of the weight
    gradients, in ``acc_dtype``; bf16 inputs run in float32 with ``h`` and
    ``w`` rounded to bf16 (K2's rounding points inside the tile)."""
    dtype = x.dtype
    x, sh, emb, w1, w2, g = _wide(x, sh, emb, w1, w2, g)
    n = layout.n_real
    dst = _segment_rows(layout.dst_ptr)
    src = layout.edge_src[:n].long()
    a = emb[:n] @ (w1 * alpha0)
    s = torch.sigmoid(a)
    h = _round_as(a * s, dtype)
    W = _round_as(h @ (w2 * alpha1), dtype)
    dx_edge, dsh, dW = _table_tp_vjp(plan.device_tables(x.device, x.dtype), x[src], sh[:n], W, g[dst])
    dh_pre = (dW @ (w2 * alpha1).t()) * (s * (1 + a * (1 - s)))
    return (dx_edge, dsh, dh_pre @ (w1 * alpha0).t()), (h, dW, dh_pre)


def conv_bwd_plain(plan, x, sh, emb, w1, w2, alpha0, alpha1, layout: EdgeLayout, g):
    """K2's inference variant in plain torch (``_conv_bwd_terms``); bf16
    outputs are rounded once (K2's rounding points: ``h``, ``w`` and each
    output)."""
    outs, _ = _conv_bwd_terms(plan, x, sh, emb, w1, w2, alpha0, alpha1, layout, g)
    return tuple(F.pad(t, (0, 0, 0, sh.shape[0] - layout.n_real)).to(x.dtype) for t in outs)


def conv_bwd_train_plain(plan, x, sh, emb, w1, w2, alpha0, alpha1, layout: EdgeLayout, g):
    """K2's training variant in plain torch: ``conv_bwd_plain``'s three
    outputs and ``dw1 = dw_reduce(emb, dh_pre, alpha0)``, ``dw2 =
    dw_reduce(h, dW, alpha1)`` over the per-edge factors, each factor
    rounded to the inputs' dtype as the kernel stores it (bf16: ``dw1`` and
    ``dw2`` are float32, ``dw_reduce_plain``)."""
    n = layout.n_real
    outs, (h, dW, dh_pre) = _conv_bwd_terms(plan, x, sh, emb, w1, w2, alpha0, alpha1, layout, g)
    h, dW, dh_pre = (t.to(x.dtype) for t in (h, dW, dh_pre))
    return tuple(F.pad(t, (0, 0, 0, sh.shape[0] - n)).to(x.dtype) for t in outs) + (
        dw_reduce_plain(emb, dh_pre, alpha0, n), dw_reduce_plain(h, dW, alpha1, n))


def dw_reduce_plain(a, b, scale: float, n: int):
    """``dw_reduce``'s twin; bf16 operands are summed in float64 and the
    result rounded to float32 once (the kernel's float32 sums, ``acc_dtype``,
    agree with that to a few float32 roundings)."""
    if a.dtype == torch.bfloat16:
        return (scale * (a[:n].double().t() @ b[:n].double())).float()
    return scale * (a[:n].t() @ b[:n])


def _sum_rows(dst, msgs, num_nodes: int, dtype, acc):
    """The per-edge ``msgs`` summed onto their destination rows: onto
    ``acc`` in place (returned), or into new rows.  bf16 (``dtype``): the
    sums run in float64 and each new row is rounded once to the nearest
    bf16, or each accumulator row (float32) takes its sum rounded to
    float32 once (the compensated sums of K4 and K6 agree with float64 to
    far below either rounding)."""
    if dtype != torch.bfloat16:
        out = msgs.new_zeros(num_nodes, msgs.shape[1]) if acc is None else acc
        return out.index_add_(0, dst, msgs)
    wide = (torch.zeros(num_nodes, msgs.shape[1], dtype=torch.float64, device=msgs.device) if acc is None
            else acc.double()).index_add_(0, dst, msgs.double())
    return _bf16_nearest(wide) if acc is None else acc.copy_(wide)


def tri_fwd_plain(plan, x, y, w, layout: EdgeLayout, acc=None):
    """K4 (``acc`` None) or K4-acc (adds onto ``acc`` in place, returns it);
    bf16 inputs run in float32 and sum as ``_sum_rows`` says."""
    dtype = x.dtype
    x, y, w = _wide(x, y, w)
    n_real = layout.n_real
    dst = _segment_rows(layout.dst_ptr)
    src = layout.edge_src[:n_real].long()
    msg = plan.tp(torch.index_select(x, 0, src), y[:n_real], w[:n_real])
    return _sum_rows(dst, msg, layout.num_nodes, dtype, acc)


def _jvp_terms(plan, x, tx, y, ty, w, dw):
    """Per-edge ``(TP(x, y, w), TP(tx, y, w) + TP(x, ty, w) + TP(x, y, dw))``."""
    return plan.tp(x, y, w), plan.tp(tx, y, w) + plan.tp(x, ty, w) + plan.tp(x, y, dw)


def jvp_fwd_plain(plan, x, tx, y, ty, w, dw, layout: EdgeLayout, acc=None):
    """K6: ``(msg, tmsg)``, added onto ``acc = (msg_acc, tmsg_acc)`` in place
    when it is given; bf16 inputs run in float32 and sum as ``_sum_rows``
    says."""
    dtype = x.dtype
    x, tx, y, ty, w, dw = _wide(x, tx, y, ty, w, dw)
    n_real = layout.n_real
    dst = _segment_rows(layout.dst_ptr)
    src = layout.edge_src[:n_real].long()
    msgs = _jvp_terms(
        plan, torch.index_select(x, 0, src), torch.index_select(tx, 0, src),
        y[:n_real], ty[:n_real], w[:n_real], dw[:n_real],
    )
    return tuple(_sum_rows(dst, m, layout.num_nodes, dtype, None if acc is None else a)
                 for m, a in zip(msgs, acc or (None, None)))


def jvp_bwd_plain(plan, x, tx, y, ty, w, dw, layout: EdgeLayout, g, gt):
    """K7: per-edge ``(dx, dtx, dy, dty, cw, cdw)`` of K6 for ``(g, gt)``;
    bf16 inputs run in float32 with each output rounded once."""
    dtype = x.dtype
    x, tx, y, ty, w, dw, g, gt = _wide(x, tx, y, ty, w, dw, g, gt)
    n_real = layout.n_real
    dst = _segment_rows(layout.dst_ptr)
    src = layout.edge_src[:n_real].long()
    with torch.enable_grad():
        ins = tuple(t.detach().requires_grad_(True)
                    for t in (x[src], tx[src], y[:n_real], ty[:n_real], w[:n_real], dw[:n_real]))
        grads = torch.autograd.grad(_jvp_terms(plan, *ins), ins, (g[dst], gt[dst]))
    return tuple(F.pad(gr, (0, 0, 0, y.shape[0] - n_real)).to(dtype) for gr in grads)


def tri_bwd_plain(plan, x, y, w, layout: EdgeLayout, g):
    """K5: per-edge ``(dx, dy, dw)`` of K4 for ``g``; bf16 inputs run in
    float32 with each output rounded once."""
    dtype = x.dtype
    x, y, w, g = _wide(x, y, w, g)
    n_real = layout.n_real
    dst = _segment_rows(layout.dst_ptr)
    src = layout.edge_src[:n_real].long()
    with torch.enable_grad():
        ins = tuple(t.detach().requires_grad_(True) for t in (x[src], y[:n_real], w[:n_real]))
        grads = torch.autograd.grad(plan.tp(*ins), ins, g[dst])
    # per-edge outputs over all slots, zero at masked ones
    return tuple(F.pad(gr, (0, 0, 0, y.shape[0] - n_real)).to(dtype) for gr in grads)


def scatter_rows_plain(values, perm, ptr):
    """K3's twin; bf16 values are summed in float32 and rounded once."""
    rows = _segment_rows(ptr)
    (wide,) = _wide(values)
    out = wide.new_zeros((ptr.shape[0] - 1,) + tuple(values.shape[1:]))
    return out.index_add_(0, rows, wide[perm[: rows.shape[0]].long()]).to(values.dtype)


def scatter_rows_edge_order(values, perm, ptr):
    """K3's arithmetic as the kernels do it: each row's sum in its sum dtype
    (float32 for bf16), from +0 in edge order ``ptr[n] -> ptr[n+1]``, rounded
    once; the card's kernels are bitwise equal to it.  A loop over segment
    positions (it reads the longest segment on the host: a reference, not a
    kernel's launch)."""
    (wide,) = _wide(values)
    start, deg = ptr[:-1].long(), (ptr[1:] - ptr[:-1]).long()
    acc = wide.new_zeros((ptr.shape[0] - 1,) + tuple(values.shape[1:]))
    for k in range(int(deg.max()) if deg.numel() else 0):
        live = deg > k
        rows = perm[torch.where(live, start + k, 0)].long()
        acc = torch.where(live[:, None], acc + wide[rows], acc)
    return acc.to(values.dtype)


def _table_pairs(tab: Dict[str, torch.Tensor]):
    """The weighted ``uvu`` TP as K1's tables give it: column ``c`` of group
    ``(row, w_off, t0, t1)`` is ``w[:, w_off + u] * sum_t coef[t] *
    x[:, x_row[t] + u] * y[:, y_col[t]]`` with ``u = c - row``
    (``TPPlan._build_tables``).  Returns, per (column, term) pair, its
    column, coefficient, x column and y column, and per column its w column."""
    groups, terms, coef, col = (tab[k] for k in ("fwd_groups", "fwd_terms", "fwd_coef", "fwd_col"))
    groups, terms = groups.long(), terms.long()
    cols = torch.arange(col.shape[0], device=coef.device)
    g = groups[col.long()]
    u = cols - g[:, 0]
    counts = g[:, 3] - g[:, 2]
    pair_col = torch.repeat_interleave(cols, counts)
    first = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    t = torch.repeat_interleave(g[:, 2], counts) + torch.arange(pair_col.shape[0], device=coef.device) - first
    return pair_col, coef[t], terms[t, 0] + u[pair_col], terms[t, 1], g[:, 1] + u


def _table_tp(tab: Dict[str, torch.Tensor], x, y, w):
    """Per-edge messages ``[E, mid_dim]`` of the TP from K1's tables alone
    (what K1 computes)."""
    pair_col, coef, xi, yi, wi = _table_pairs(tab)
    s = x.new_zeros(x.shape[0], wi.shape[0]).index_add_(1, pair_col, coef * x[:, xi] * y[:, yi])
    return s * w[:, wi]


def _table_tp_vjp(tab: Dict[str, torch.Tensor], x, y, w, g):
    """``(dx, dy, dw)`` of ``_table_tp`` for the per-edge cotangent ``g``."""
    pair_col, coef, xi, yi, wi = _table_pairs(tab)
    s = x.new_zeros(x.shape[0], wi.shape[0]).index_add_(1, pair_col, coef * x[:, xi] * y[:, yi])
    dw = torch.zeros_like(w).index_add_(1, wi, g * s)
    ds = coef * (g * w[:, wi])[:, pair_col]
    return (torch.zeros_like(x).index_add_(1, xi, ds * y[:, yi]),
            torch.zeros_like(y).index_add_(1, yi, ds * x[:, xi]), dw)


class _TablePlan(NamedTuple):
    """What the plain twins of K1 and K2 read of a ``TPPlan``, from its
    tables: the CPU kernels of the registered ops get tensors, not plans."""

    tab: Dict[str, torch.Tensor]

    @property
    def mid_dim(self) -> int:
        return self.tab["fwd_col"].shape[0]

    def device_tables(self, device, dtype) -> Dict[str, torch.Tensor]:
        return self.tab

    def tp(self, x, y, w):
        return _table_tp(self.tab, x, y, w)


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
        if fwAD.unpack_dual(t).tangent is not None:
            raise RuntimeError(f"{name}: a forward-mode dual tensor reached a kernel (use the module jvp rules)")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return True


def _check_coefs(name: str, tables, like: torch.Tensor) -> None:
    """The float term tables of a registered op's ``tables`` (``TABLE_NAMES``
    order) lie contiguous on ``like``'s device in ``acc_dtype(like.dtype)``."""
    dtype = acc_dtype(like.dtype)
    for i in _COEF:
        t = tables[i]
        if t.device != like.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: the term tables' coefficients must be contiguous {dtype} on the inputs' device")


def _check_index(device: torch.device, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("edge layout tensors must be contiguous int32 on the kernel's device")


def _check_layout(layout: EdgeLayout, device: torch.device) -> None:
    _check_index(device, layout.edge_src, layout.dst_ptr, layout.src_perm, layout.src_ptr)


def conv_fwd_carry_rows(n_edges: int, tile: int, dtype: torch.dtype = torch.float32) -> int:
    """Rows of the carry buffer of K1, K4 and K6 over ``n_edges`` edges (at
    least the real ones): one per tile of ``tile`` edges (a tile whose last
    destination continues into the next tile writes its part there, see
    ``csrc/cg_fwd.cuh``); four per tile in bf16 (two parts, each a
    compensated float32 sum's hi and lo rows; the second part is a tile's
    first destination's that began in an earlier tile, see ``carry_slots``
    in ``csrc/cg_fwd.cuh``).  The rows are in ``acc_dtype(dtype)``, of
    ``mid_dim`` values (K6: ``2 * mid_dim``, msg and tmsg)."""
    return _cdiv(n_edges, tile) * (4 if dtype == torch.bfloat16 else 1)


# edges per tile of K1, K4 and K6 by (kernel, device, dtype, widths): the
# library's answer for the card the process runs on, asked at first launch
_TILES: Dict[tuple, int] = {}


def _tile(name: str, dtype: torch.dtype, device, widths: Tuple[int, ...]) -> int:
    """Edges per tile that kernel ``name`` takes at ``widths`` on a CUDA
    ``device`` (32, 16, 8 or 4, as its shared memory fits), asked of the
    library once per process; raises if no tile fits."""
    device = torch.device(device)
    key = (name, device, dtype, widths)
    if key not in _TILES:
        with torch.cuda.device(device):
            tile = build.entry_point(f"nequip_{name}_tile", dtype)(*widths)
        if tile < 0:
            build.check(-tile, name)
        if tile == 0:
            raise RuntimeError(f"{name}: no edge tile fits in shared memory at widths {widths} in {dtype}")
        _TILES[key] = tile
    return _TILES[key]


def conv_fwd_tile(plan: TPPlan, n_emb: int, hidden: int, dtype: torch.dtype, device) -> int:
    """Edges per tile of K1 (32, 16 or 8: the largest whose shared memory
    fits one block) for ``plan`` with an ``n_emb -> hidden -> WN`` radial
    MLP on a CUDA ``device``."""
    return _tile("conv_fwd", dtype, device, (plan.dim_in, plan.sh_dim, n_emb, hidden, plan.weight_numel,
                                             len(plan._tables["fwd_coef"])))


def tri_fwd_tile(plan: TPPlan, name: str, dtype: torch.dtype, device) -> int:
    """Edges per tile of K4 and K4-acc (``name`` "tri_fwd") or K6 ("jvp_fwd")
    for ``plan`` on a CUDA ``device``."""
    return _tile(name, dtype, device, (plan.dim_in, plan.sh_dim, plan.weight_numel, len(plan._tables["fwd_coef"])))


def conv_fwd(plan: TPPlan, x, sh, emb, w1, w2, alpha0: float, alpha1: float, layout: EdgeLayout):
    """K1: ``[N, mid_dim]`` fused conv messages (see ``csrc/conv_fwd.cu``:
    dense tiles of 32 edges with the radial MLP as a block GEMM in shared
    memory).  It allocates its output and the ``[n_tiles, mid_dim]`` carry
    rows of destinations that tiles split, and no per-edge buffer.  The
    carry rows are counted over all edge slots, not the real edges, so that
    a CUDA graph of the call stays in bounds when replayed on a layout
    refilled with more real edges (``integrations/md.py``); the kernel reads
    the real-edge count from ``dst_ptr`` on the device."""
    if not _route("conv_fwd", x, sh, emb, w1, w2):
        return conv_fwd_plain(plan, x, sh, emb, w1, w2, alpha0, alpha1, layout)
    _check_layout(layout, x.device)
    return _launch_conv_fwd(x, sh, emb, w1, w2, layout.edge_src, layout.dst_ptr,
                            plan.device_tables(x.device, acc_dtype(x.dtype)), alpha0, alpha1)


def _launch_conv_fwd(x, sh, emb, w1, w2, edge_src, dst_ptr, tab: Dict[str, torch.Tensor], alpha0, alpha1):
    """K1's launch on raw tensors (the wrapper's and the registered op's)."""
    n_emb, hidden = w1.shape
    num_nodes, dim_in, sh_dim, wn = dst_ptr.shape[0] - 1, x.shape[1], sh.shape[1], w2.shape[1]
    mid_dim, n_terms = tab["fwd_col"].shape[0], tab["fwd_coef"].shape[0]
    tile = _tile("conv_fwd", x.dtype, x.device, (dim_in, sh_dim, n_emb, hidden, wn, n_terms))
    out = torch.empty(num_nodes, mid_dim, dtype=x.dtype, device=x.device)
    carry = torch.empty(conv_fwd_carry_rows(edge_src.shape[0], tile, x.dtype), mid_dim, dtype=acc_dtype(x.dtype),
                        device=x.device)
    err = build.entry_point("nequip_conv_fwd", x.dtype)(
        x.data_ptr(), sh.data_ptr(), emb.data_ptr(), w1.data_ptr(), w2.data_ptr(),
        edge_src.data_ptr(), dst_ptr.data_ptr(),
        tab["fwd_groups"].data_ptr(), tab["fwd_terms"].data_ptr(),
        tab["fwd_coef"].data_ptr(), tab["fwd_col"].data_ptr(), out.data_ptr(), carry.data_ptr(),
        num_nodes, dim_in, sh_dim, n_emb, hidden, wn, mid_dim, n_terms, tile, alpha0, alpha1,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "conv_fwd")
    conv_fwd.launches += 1
    return out


def _launch_conv_bwd(x, sh, emb, w1, w2, edge_src, dst_ptr, g, tab: Dict[str, torch.Tensor], alpha0, alpha1,
                     n_real: Optional[int] = None):
    """K2's launch on raw tensors: the inference variant, or with ``n_real``
    (the real edges, known on the host) the training variant, which also
    returns its per-edge dW factors over the real slots."""
    n_emb, hidden = w1.shape
    num_nodes, dim_in, sh_dim, wn, mid_dim = dst_ptr.shape[0] - 1, x.shape[1], sh.shape[1], w2.shape[1], g.shape[1]
    w2t = w2.t().contiguous()
    if n_real is None:
        # the kernel writes the real slots only, and their count stays on the device
        dx_edge = torch.zeros(sh.shape[0], dim_in, dtype=x.dtype, device=x.device)
    else:
        dx_edge = torch.empty(sh.shape[0], dim_in, dtype=x.dtype, device=x.device)
        dx_edge[n_real:].zero_()
    dsh = torch.zeros_like(sh)
    demb = torch.zeros_like(emb)
    args = [
        x.data_ptr(), sh.data_ptr(), emb.data_ptr(), w1.data_ptr(), w2.data_ptr(),
        w2t.data_ptr(), edge_src.data_ptr(), dst_ptr.data_ptr(), g.data_ptr(),
        tab["dx_groups"].data_ptr(), tab["dx_terms"].data_ptr(), tab["dx_coef"].data_ptr(),
        tab["dx_col"].data_ptr(), tab["paths"].data_ptr(), tab["path_terms"].data_ptr(),
        tab["path_coef"].data_ptr(), dx_edge.data_ptr(), dsh.data_ptr(), demb.data_ptr(),
    ]
    per_edge = ()
    if n_real is not None:
        # per-edge factors of dW2 / dW1 over the real slots, reduced by dw_reduce
        per_edge = tuple(
            torch.empty(n_real, width, dtype=x.dtype, device=x.device) for width in (wn, hidden, hidden)
        )
        args += [t.data_ptr() for t in per_edge]
    args += [
        tab["paths"].shape[0], num_nodes, dim_in, sh_dim, n_emb, hidden, wn, mid_dim, alpha0, alpha1,
        torch.cuda.current_stream(x.device).cuda_stream,
    ]
    name = "conv_bwd" if n_real is None else "conv_bwd_train"
    build.check(build.entry_point(f"nequip_{name}", x.dtype)(*args), name)
    if n_real is None:
        conv_bwd.launches += 1
        return dx_edge, dsh, demb
    conv_bwd_train.launches += 1
    return (dx_edge, dsh, demb), per_edge


def conv_bwd(plan: TPPlan, x, sh, emb, w1, w2, alpha0: float, alpha1: float, layout: EdgeLayout, g):
    """K2, inference variant: per-edge ``(dx [E, dim_in], dsh [E, sh_dim],
    demb [E, n_emb])`` of K1 for the node cotangent ``g`` (see
    ``csrc/conv_bwd.cu``: dense tiles of 32 edges with the radial MLP as
    block GEMMs in shared memory); zero rows at masked slots.  It allocates
    no per-edge buffer besides its three outputs.  Like the registered op,
    it leaves the real-edge count on the device."""
    if not _route("conv_bwd", x, sh, emb, w1, w2, g):
        return conv_bwd_plain(plan, x, sh, emb, w1, w2, alpha0, alpha1, layout, g)
    _check_layout(layout, x.device)
    return _launch_conv_bwd(x, sh, emb, w1, w2, layout.edge_src, layout.dst_ptr, g,
                            plan.device_tables(x.device, acc_dtype(x.dtype)), alpha0, alpha1)


def conv_bwd_train(plan: TPPlan, x, sh, emb, w1, w2, alpha0: float, alpha1: float, layout: EdgeLayout, g):
    """K2, training variant: ``conv_bwd``'s three outputs and the radial-MLP
    weight gradients ``dw1 [n_emb, hidden]``, ``dw2 [hidden, WN]``.  The
    kernel writes the per-edge ``dW_e``, ``h_e`` and ``dh_pre_e`` (in the
    inputs' dtype: bf16 rounded once); ``dw_reduce`` sums them over the
    edges (bf16: into float32 ``dw1``, ``dw2``)."""
    if not _route("conv_bwd_train", x, sh, emb, w1, w2, g):
        return conv_bwd_train_plain(plan, x, sh, emb, w1, w2, alpha0, alpha1, layout, g)
    _check_layout(layout, x.device)
    n = layout.n_real
    tab = plan.device_tables(x.device, acc_dtype(x.dtype))
    _check_coefs("conv_bwd_train", tuple(tab.values()), x)
    outs, (dw_e, h_e, dh_e) = _launch_conv_bwd(x, sh, emb, w1, w2, layout.edge_src, layout.dst_ptr, g, tab,
                                               alpha0, alpha1, n_real=n)
    return outs + (dw_reduce(emb, dh_e, alpha0, n), dw_reduce(h_e, dw_e, alpha1, n))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _dw_tile(P: int, Q: int, dtype=torch.float32) -> Tuple[int, int, int]:
    """``dw_reduce``'s block tile for ``a [n, P]``, ``b [n, Q]`` of
    ``dtype``: (rows of P, columns of Q, resident blocks per SM).  bf16's
    wide tile takes the fewest column tiles of at most 352 columns, each
    the narrowest multiple of 32 that covers Q (``launch_pass1`` in
    ``csrc/dw_reduce.cu``)."""
    if dtype != torch.bfloat16:
        return _DW_NARROW if P <= _DW_NARROW[0] else _DW_WIDE
    if P <= _DW_BF16_NARROW[0]:
        return _DW_BF16_NARROW
    rows, widest, step = _DW_BF16_WIDE
    return rows, step * _cdiv(_cdiv(Q, _cdiv(Q, widest)), step), 1


def _dw_chunks(n: int, tiles: int, per_sm: int, depth: int, cap: Optional[int] = None) -> Tuple[int, int]:
    """``(S, chunk)`` for ``tiles`` block tiles a chunk at ``per_sm`` blocks
    an SM: ``S`` times ``tiles`` fills one wave of the card's SMs, or whole
    waves where a chunk would be longer than ``cap`` edges; chunks are a
    multiple of ``depth`` edges, at least ``_DW_MIN_CHUNK``."""
    per_wave = _cdiv(_DW_SMS * per_sm, tiles)
    S = per_wave if cap is None else per_wave * _cdiv(max(1, _cdiv(n, cap)), per_wave)
    chunk = max(_DW_MIN_CHUNK, depth * _cdiv(_cdiv(n, S), depth))
    return max(1, _cdiv(n, chunk)), chunk


def _dw_split(n: int, P: int, Q: int, dtype=torch.float32) -> Tuple[int, int]:
    """``(S, chunk)``: ``dw_reduce`` sums the edges ``[c * chunk, min(n, (c +
    1) * chunk))`` of each chunk ``c < S`` into a partial, then the partials
    in chunk order, so the summation order depends on ``(n, P, Q)`` and the
    dtype alone.  ``S`` times the output's block tiles (``_dw_tile``) fills
    one wave of the card's SMs, with chunks of at least ``_DW_MIN_CHUNK``
    edges, a multiple of 32; bf16's chunks are whole slabs
    (``_DW_BF16_SLAB``) of at most ``_DW_BF16_MAX_CHUNK`` edges, in whole
    waves."""
    rows, cols, per_sm = _dw_tile(P, Q, dtype)
    tiles = _cdiv(P, rows) * _cdiv(Q, cols)
    if dtype == torch.bfloat16:
        return _dw_chunks(n, tiles, per_sm, _DW_BF16_SLAB, _DW_BF16_MAX_CHUNK)
    return _dw_chunks(n, tiles, per_sm, 32)


def dw_reduce(a, b, scale: float, n: int):
    """``scale * a[:n]^T b[:n]`` (``[P, Q]``) in a fixed summation order (see
    ``csrc/dw_reduce.cu`` and ``_dw_split``): two calls give bitwise equal
    results.  bf16 operands are summed in float32 into a float32 result
    (``acc_dtype``)."""
    if not _route("dw_reduce", a, b):
        return dw_reduce_plain(a, b, scale, n)
    if a.dim() != 2 or b.dim() != 2 or not (0 <= n <= a.shape[0] and n <= b.shape[0]):
        raise ValueError("dw_reduce: a [M, P] and b [M, Q] need at least n rows")
    P, Q = a.shape[1], b.shape[1]
    n_chunks, chunk = _dw_split(n, P, Q, a.dtype)
    partial = torch.empty(n_chunks, P, Q, dtype=acc_dtype(a.dtype), device=a.device)
    out = torch.empty(P, Q, dtype=acc_dtype(a.dtype), device=a.device)
    err = build.entry_point("nequip_dw_reduce", a.dtype)(
        a.data_ptr(), b.data_ptr(), partial.data_ptr(), out.data_ptr(), n, P, Q, chunk, n_chunks,
        scale, torch.cuda.current_stream(a.device).cuda_stream,
    )
    build.check(err, "dw_reduce")
    dw_reduce.launches += 1
    return out


def _check_acc(name: str, acc, layout: EdgeLayout, plan: TPPlan, ref: torch.Tensor) -> None:
    """Accumulators lie contiguous ``[N, mid_dim]`` on ``ref``'s device in
    ``acc_dtype(ref.dtype)`` (float32 for bf16 inputs)."""
    dtype = acc_dtype(ref.dtype)
    for a in acc:
        if (a.shape != (layout.num_nodes, plan.mid_dim) or a.device != ref.device
                or a.dtype != dtype or not a.is_contiguous()):
            raise ValueError(f"{name}: accumulators must be contiguous [N, mid_dim] {dtype} on the inputs' device")


def tri_fwd(plan: TPPlan, x, y, w, layout: EdgeLayout, acc=None):
    """K4: ``[N, mid_dim]`` trilinear conv with per-edge weights ``w [E, WN]``
    (see ``csrc/tri_fwd.cu``: dense edge tiles, the CG forward shared with
    K1).  With ``acc`` (K4-acc, counted as ``tri_fwd_acc``) the messages are
    added onto ``acc`` in place and ``acc`` is returned: one slice of the
    edge-chunked sweep.  It allocates its output (none with ``acc``) and
    the carry rows of destinations that tiles split.  bf16: ``out`` is bf16,
    ``acc`` float32 (``acc_dtype``)."""
    if acc is not None:
        return tri_fwd_acc(plan, x, y, w, layout, acc)
    if not _route("tri_fwd", x, y, w):
        return tri_fwd_plain(plan, x, y, w, layout)
    out = torch.empty(layout.num_nodes, plan.mid_dim, dtype=x.dtype, device=x.device)
    _launch_tri_fwd("nequip_tri_fwd", plan, x, y, w, layout, out)
    tri_fwd.launches += 1
    return out


def tri_fwd_acc(plan: TPPlan, x, y, w, layout: EdgeLayout, acc):
    """K4-acc: ``acc += F(x, y, w)`` in place over one edge slice."""
    _check_acc("tri_fwd_acc", (acc,), layout, plan, x)
    if not _route("tri_fwd_acc", x, y, w):
        return tri_fwd_plain(plan, x, y, w, layout, acc)
    _launch_tri_fwd("nequip_tri_fwd_acc", plan, x, y, w, layout, acc)
    tri_fwd_acc.launches += 1
    return acc


def _launch_tri_fwd(entry: str, plan: TPPlan, x, y, w, layout: EdgeLayout, out) -> None:
    _check_layout(layout, x.device)
    _launch_tri_fwd_raw(entry, x, y, w, layout.edge_src, layout.dst_ptr,
                        plan.device_tables(x.device, acc_dtype(x.dtype)), out, layout.n_real)


def _launch_tri_fwd_raw(entry: str, x, y, w, edge_src, dst_ptr, tab: Dict[str, torch.Tensor], out,
                        n_edges: int) -> None:
    """K4's launch on raw tensors (the wrapper's and the registered op's);
    ``n_edges`` (at least the real edges) sizes the carry rows."""
    n_terms, mid_dim = tab["fwd_coef"].shape[0], tab["fwd_col"].shape[0]
    dim_in, sh_dim, wn = x.shape[1], y.shape[1], w.shape[1]
    tile = _tile("tri_fwd", x.dtype, x.device, (dim_in, sh_dim, wn, n_terms))
    carry = torch.empty(conv_fwd_carry_rows(n_edges, tile, x.dtype), mid_dim, dtype=acc_dtype(x.dtype),
                        device=x.device)
    err = build.entry_point(entry, x.dtype)(
        x.data_ptr(), y.data_ptr(), w.data_ptr(), edge_src.data_ptr(),
        dst_ptr.data_ptr(), tab["fwd_groups"].data_ptr(), tab["fwd_terms"].data_ptr(),
        tab["fwd_coef"].data_ptr(), tab["fwd_col"].data_ptr(), out.data_ptr(), carry.data_ptr(),
        n_terms, dst_ptr.shape[0] - 1, dim_in, sh_dim, wn, mid_dim,
        tile, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, entry)


def jvp_fwd(plan: TPPlan, x, tx, y, ty, w, dw, layout: EdgeLayout, acc=None):
    """K6: ``(msg, tmsg) = (F(x, y, w), F(tx, y, w) + F(x, ty, w) + F(x, y, dw))``
    in one pass (see ``csrc/jvp_fwd.cu``).  With ``acc = (msg_acc,
    tmsg_acc)`` both are added onto the accumulators in place, which are
    returned.  It allocates its outputs (none with ``acc``) and ``[n_tiles,
    2 mid_dim]`` carry rows.  bf16: the outputs are bf16, the accumulators
    float32 (``acc_dtype``)."""
    if acc is not None:
        _check_acc("jvp_fwd", acc, layout, plan, x)
    if not _route("jvp_fwd", x, tx, y, ty, w, dw):
        return jvp_fwd_plain(plan, x, tx, y, ty, w, dw, layout, acc)
    _check_layout(layout, x.device)
    if acc is None:
        acc = tuple(torch.empty(layout.num_nodes, plan.mid_dim, dtype=x.dtype, device=x.device)
                    for _ in range(2))
        entry = "nequip_jvp_fwd"
    else:
        entry = "nequip_jvp_fwd_acc"
    tab = plan.device_tables(x.device, acc_dtype(x.dtype))
    tile = tri_fwd_tile(plan, "jvp_fwd", x.dtype, x.device)
    carry = torch.empty(conv_fwd_carry_rows(layout.n_real, tile, x.dtype), 2 * plan.mid_dim,
                        dtype=acc_dtype(x.dtype), device=x.device)
    err = build.entry_point(entry, x.dtype)(
        x.data_ptr(), tx.data_ptr(), y.data_ptr(), ty.data_ptr(), w.data_ptr(), dw.data_ptr(),
        layout.edge_src.data_ptr(), layout.dst_ptr.data_ptr(), tab["fwd_groups"].data_ptr(),
        tab["fwd_terms"].data_ptr(), tab["fwd_coef"].data_ptr(), tab["fwd_col"].data_ptr(),
        acc[0].data_ptr(), acc[1].data_ptr(), carry.data_ptr(), tab["fwd_coef"].shape[0], layout.num_nodes,
        plan.dim_in, plan.sh_dim, plan.weight_numel, plan.mid_dim, tile,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, entry)
    jvp_fwd.launches += 1
    return tuple(acc)


def jvp_bwd(plan: TPPlan, x, tx, y, ty, w, dw, layout: EdgeLayout, g, gt):
    """K7: per-edge ``(dx [E, dim_in], dtx [E, dim_in], dy [E, sh_dim],
    dty [E, sh_dim], cw [E, WN], cdw [E, WN])`` of K6 for the node cotangents
    ``g`` of msg and ``gt`` of tmsg (see ``csrc/jvp_bwd.cu``); zero rows at
    masked slots."""
    if not _route("jvp_bwd", x, tx, y, ty, w, dw, g, gt):
        return jvp_bwd_plain(plan, x, tx, y, ty, w, dw, layout, g, gt)
    _check_layout(layout, x.device)
    tab = plan.device_tables(x.device, acc_dtype(x.dtype))
    outs = tuple(
        torch.empty(y.shape[0], width, dtype=x.dtype, device=x.device)
        for width in (plan.dim_in, plan.dim_in, plan.sh_dim, plan.sh_dim, plan.weight_numel, plan.weight_numel)
    )
    for t in outs:
        t[layout.n_real:].zero_()  # the kernel writes the real slots only
    err = build.entry_point("nequip_jvp_bwd", x.dtype)(
        x.data_ptr(), tx.data_ptr(), y.data_ptr(), ty.data_ptr(), w.data_ptr(), dw.data_ptr(),
        layout.edge_src.data_ptr(), layout.dst_ptr.data_ptr(), g.data_ptr(), gt.data_ptr(),
        tab["dx_groups"].data_ptr(), tab["dx_terms"].data_ptr(), tab["dx_coef"].data_ptr(),
        tab["dx_col"].data_ptr(), tab["paths"].data_ptr(), tab["path_terms"].data_ptr(),
        tab["path_coef"].data_ptr(), *(t.data_ptr() for t in outs), len(plan.paths),
        layout.num_nodes, plan.dim_in, plan.sh_dim, plan.weight_numel, plan.mid_dim,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "jvp_bwd")
    jvp_bwd.launches += 1
    return outs


def tri_bwd(plan: TPPlan, x, y, w, layout: EdgeLayout, g):
    """K5: per-edge ``(dx [E, dim_in], dy [E, sh_dim], dw [E, WN])`` of K4 for
    the node cotangent ``g`` (see ``csrc/tri_bwd.cu``); zero rows at masked
    slots."""
    if not _route("tri_bwd", x, y, w, g):
        return tri_bwd_plain(plan, x, y, w, layout, g)
    _check_layout(layout, x.device)
    tab = plan.device_tables(x.device, acc_dtype(x.dtype))
    n_real = layout.n_real
    outs = tuple(
        torch.empty(y.shape[0], width, dtype=x.dtype, device=x.device)
        for width in (plan.dim_in, plan.sh_dim, plan.weight_numel)
    )
    for t in outs:
        t[n_real:].zero_()  # the kernel writes the real slots only
    _launch_tri_bwd_raw(x, y, w, layout.edge_src, layout.dst_ptr, g, tab, outs)
    tri_bwd.launches += 1
    return outs


def _launch_tri_bwd_raw(x, y, w, edge_src, dst_ptr, g, tab: Dict[str, torch.Tensor], outs) -> None:
    """K5's launch on raw tensors into ``outs = (dx_edge, dy, dw)`` (the
    wrapper's and the registered op's)."""
    dx_edge, dy, dw = outs
    err = build.entry_point("nequip_tri_bwd", x.dtype)(
        x.data_ptr(), y.data_ptr(), w.data_ptr(), edge_src.data_ptr(),
        dst_ptr.data_ptr(), g.data_ptr(), tab["dx_groups"].data_ptr(),
        tab["dx_terms"].data_ptr(), tab["dx_coef"].data_ptr(), tab["dx_col"].data_ptr(),
        tab["paths"].data_ptr(), tab["path_terms"].data_ptr(), tab["path_coef"].data_ptr(),
        dx_edge.data_ptr(), dy.data_ptr(), dw.data_ptr(), tab["paths"].shape[0], dst_ptr.shape[0] - 1,
        x.shape[1], y.shape[1], w.shape[1], tab["fwd_col"].shape[0],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "tri_bwd")


def scatter_rows(values, perm, ptr):
    """K3: ``out[n] = sum_{j in ptr[n]:ptr[n+1]} values[perm[j]]`` (see
    ``csrc/scatter_rows.cu``)."""
    if not _route("scatter_rows", values):
        return scatter_rows_plain(values, perm, ptr)
    return _launch_scatter_rows(values, perm, ptr)


SCATTER_THREADS = 128  # threads of a bf16 K3 block (scatter_rows.cu kScatterThreads)
SCATTER_MAX_PER_LANE = 4  # vectors a lane holds a pass (scatter_rows.cu kScatterMaxK)


class ScatterGeometry(NamedTuple):
    """The launch of bf16 K3 (``scatter_rows_bf16_kernel``): loads of ``vec``
    bf16 values, ``lanes`` lanes a row, each holding ``per_lane`` vectors a
    pass (lane ``sub``: vectors ``sub + k lanes``), ``32 // lanes`` rows a
    warp, blocks of ``SCATTER_THREADS``."""

    vec: int
    lanes: int
    per_lane: int

    @property
    def rows_per_warp(self) -> int:
        return 32 // self.lanes

    @property
    def rows_per_block(self) -> int:
        return SCATTER_THREADS // 32 * self.rows_per_warp


@lru_cache(maxsize=None)
def scatter_rows_geometry(d: int, aligned: bool) -> ScatterGeometry:
    """bf16 K3's launch for rows of ``d`` values, from ``d`` and whether the
    values' base is 16-byte aligned alone (no value of the data): 16-byte
    loads (8 values) where both allow, else 2-byte ones; then the lanes a
    row that cover it in the fewest passes (one up to 128 vectors) and leave
    the fewest of a warp's vector slots idle, ties to fewer vectors a lane
    (registers), then fewer lanes."""
    vec = 8 if aligned and d % 8 == 0 else 1
    nv = d // vec
    best = None
    for lanes in range(1, 33):
        per_lane = max(1, min(-(-nv // lanes), SCATTER_MAX_PER_LANE))
        passes = max(1, -(-nv // (lanes * per_lane)))
        used = nv * (32 // lanes) / (32 * per_lane * passes)
        key = (passes, -used, per_lane, lanes)
        if best is None or key < best[0]:
            best = (key, ScatterGeometry(vec, lanes, per_lane))
    return best[1]


def _launch_scatter_rows(values, perm, ptr):
    for t in (perm, ptr):
        if t.device != values.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("scatter_rows: perm and ptr must be contiguous int32 on the values' device")
    if values.dim() != 2:
        raise ValueError("scatter_rows: values must be [M, D]")
    n_rows = ptr.shape[0] - 1
    out = torch.empty(n_rows, values.shape[1], dtype=values.dtype, device=values.device)
    if values.dtype == torch.bfloat16:
        # the stream handle from _cuda_getCurrentRawStream: 0.2 us on the card's host against 10 us for
        # current_stream(device).cuda_stream, host time the card waits for when nothing else is queued
        g = scatter_rows_geometry(values.shape[1], values.data_ptr() % 16 == 0)
        err = build.entry_point("nequip_scatter_rows", values.dtype)(
            values.data_ptr(), perm.data_ptr(), ptr.data_ptr(), out.data_ptr(), n_rows, values.shape[1],
            g.vec, g.lanes, g.per_lane, torch._C._cuda_getCurrentRawStream(values.device.index),
        )
    else:
        err = build.entry_point("nequip_scatter_rows", values.dtype)(
            values.data_ptr(), perm.data_ptr(), ptr.data_ptr(), out.data_ptr(),
            n_rows, values.shape[1], torch.cuda.current_stream(values.device).cuda_stream,
        )
    build.check(err, "scatter_rows")
    scatter_rows.launches += 1
    return out


# every kernel's launch count; ``microbench`` (T1-T4) and ``row_gather`` (T5)
# add theirs when the package imports them (``ops/kernels/__init__.py``)
KERNELS = {
    "conv_fwd": conv_fwd,
    "conv_bwd": conv_bwd,
    "conv_bwd_train": conv_bwd_train,
    "dw_reduce": dw_reduce,
    "scatter_rows": scatter_rows,
    "tri_fwd": tri_fwd,
    "tri_fwd_acc": tri_fwd_acc,
    "tri_bwd": tri_bwd,
    "jvp_fwd": jvp_fwd,
    "jvp_bwd": jvp_bwd,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


reset_launch_counts()


# ---------------------------------------------------------------------------
# autograd: the fused conv and the trilinear family, closed under AD
# ---------------------------------------------------------------------------
def _add(*terms):
    """Sum of the terms that are not None (None if all are)."""
    terms = [t for t in terms if t is not None]
    return sum(terms[1:], terms[0]) if terms else None


def _dx_nodes(dx_edge, layout: EdgeLayout):
    return scatter_rows(dx_edge, layout.src_perm, layout.src_ptr)


class FusedConv(torch.autograd.Function):
    """``out = scatter_dst(TP(x[src], sh, MLP(emb; w1, w2)))`` with K1 as
    forward, for training (the radial-MLP weights need gradients): its
    backward is ``FusedConvBwd`` (K2's training variant), differentiable
    again for force losses.  Serving takes the registered op instead
    (``fused_tp_scatter_mlp``)."""

    @staticmethod
    def forward(ctx, x, sh, emb, w1, w2, plan, alpha0, alpha1, layout):
        ctx.plan, ctx.alphas, ctx.layout = plan, (alpha0, alpha1), layout
        ctx.save_for_backward(x, sh, emb, w1, w2)
        return conv_fwd(plan, x, sh, emb, w1, w2, alpha0, alpha1, layout)

    @staticmethod
    def backward(ctx, g):
        x, sh, emb, w1, w2 = ctx.saved_tensors
        need = ctx.needs_input_grad
        grads = FusedConvBwd.apply(x, sh, emb, w1, w2, g.contiguous(), ctx.plan, *ctx.alphas, ctx.layout)
        return tuple(gr if nd else None for gr, nd in zip(grads, need[:5])) + (None,) * 4


def _conv_bwd_composition(plan, x, sh, emb, w1, w2, g, alpha0, alpha1, layout: EdgeLayout):
    """K2 (with K3) as a differentiable composition, the JAX ``_bwd_ref``:
    ``W = MLP(emb)`` in plain torch, ``(dx, dsh, dW) = TriConvBwd(x, sh, W, g)``
    and ``(demb, dw1, dw2)`` the MLP's VJP at ``dW``.  The MLP runs on the
    real slots only; ``W`` and ``demb`` are zero at masked slots."""
    n, n_pad = layout.n_real, emb.shape[0] - layout.n_real
    e = emb[:n]
    a = e @ (w1 * alpha0)
    s = torch.sigmoid(a)
    h = a * s
    W = F.pad(h @ (w2 * alpha1), (0, 0, 0, n_pad))
    dx, dsh, dW = TriConvBwd.apply(x, sh, W, g, plan, layout)
    dW = dW[:n]
    dh_pre = (dW @ (w2 * alpha1).t()) * (s * (1 + a * (1 - s)))
    demb = F.pad(dh_pre @ (w1 * alpha0).t(), (0, 0, 0, n_pad))
    return dx, dsh, demb, alpha0 * (e.t() @ dh_pre), alpha1 * (h.t() @ dW)


class FusedConvBwd(torch.autograd.Function):
    """``(dx, dsh, demb, dw1, dw2)`` of ``FusedConv`` for the node cotangent
    ``g``: K2's training variant, then K3 for ``dx``.  ``dw1``/``dw2`` come
    in the dtype of the ``w1``/``w2`` given: a bf16 block passes bf16 copies
    of its float32 parameters (``InteractionBlock.conv``), so their float32
    sums (``dw_reduce``) are rounded to bf16 once here and reach the
    parameters through the copy's cast, as JAX's ``astype`` of the
    parameters rounds them.  Its backward (the JAX ``kernel_bwd_bwd``)
    differentiates ``_conv_bwd_composition``, whose trilinear part runs K4
    and K5."""

    @staticmethod
    def forward(ctx, x, sh, emb, w1, w2, g, plan, alpha0, alpha1, layout):
        ctx.plan, ctx.alphas, ctx.layout = plan, (alpha0, alpha1), layout
        ctx.save_for_backward(x, sh, emb, w1, w2, g)
        ctx.set_materialize_grads(False)
        dx_edge, dsh, demb, dw1, dw2 = conv_bwd_train(plan, x, sh, emb, w1, w2, alpha0, alpha1, layout, g)
        return _dx_nodes(dx_edge, layout), dsh, demb, dw1.to(w1.dtype), dw2.to(w2.dtype)

    @staticmethod
    def backward(ctx, *cts):
        wrt = [i for i, nd in enumerate(ctx.needs_input_grad[:6]) if nd]
        used = [i for i, c in enumerate(cts) if c is not None]
        grads = [None] * 6
        if wrt and used:
            create = torch.is_grad_enabled()  # a graph of this backward is asked for
            with torch.enable_grad():
                # views keep the inputs' history when a graph is built
                ins = [
                    t.view_as(t) if create and t.requires_grad else t.detach().requires_grad_(True)
                    for t in ctx.saved_tensors
                ]
                outs = _conv_bwd_composition(ctx.plan, *ins, *ctx.alphas, ctx.layout)
                found = torch.autograd.grad(
                    [outs[i] for i in used], [ins[i] for i in wrt], [cts[i] for i in used],
                    allow_unused=True, create_graph=create,
                )
            for i, gr in zip(wrt, found):
                grads[i] = gr
        return (*grads, None, None, None, None)


class TriConv(torch.autograd.Function):
    """``F(x, y, w) = scatter_dst(TP(x[src], y, w))`` with K4 as forward and
    ``TriConvBwd`` as backward."""

    @staticmethod
    def forward(ctx, x, y, w, plan, layout):
        ctx.plan, ctx.layout = plan, layout
        ctx.save_for_backward(x, y, w)
        return tri_fwd(plan, x, y, w, layout)

    @staticmethod
    def backward(ctx, g):
        x, y, w = ctx.saved_tensors
        grads = TriConvBwd.apply(x, y, w, g.contiguous(), ctx.plan, ctx.layout)
        return tuple(gr if nd else None for gr, nd in zip(grads, ctx.needs_input_grad[:3])) + (None, None)


class TriConvBwd(torch.autograd.Function):
    """``B(x, y, w, g) = (dx, dy, dw)``, the VJP of ``F``: K5, then K3 for
    ``dx``.  As ``F`` is trilinear, ``B``'s VJP is three ``F`` and three ``B``
    calls (JAX ``bwd_bwd``): for cotangents ``(cx, cy, cw)``,
    ``dg = F(cx, y, w) + F(x, cy, w) + F(x, y, cw)``, and each input's
    cotangent collects the ``B`` calls that substitute another operand."""

    @staticmethod
    def forward(ctx, x, y, w, g, plan, layout):
        ctx.plan, ctx.layout = plan, layout
        ctx.save_for_backward(x, y, w, g)
        ctx.set_materialize_grads(False)
        dx_edge, dy, dw = tri_bwd(plan, x, y, w, layout, g)
        return _dx_nodes(dx_edge, layout), dy, dw

    @staticmethod
    def backward(ctx, cx, cy, cw):
        x, y, w, g = ctx.saved_tensors
        plan, layout = ctx.plan, ctx.layout
        need_x, need_y, need_w, need_g = ctx.needs_input_grad[:4]
        cx, cy, cw = (None if c is None else c.contiguous() for c in (cx, cy, cw))

        def fwd(a, b, c):
            return TriConv.apply(a, b, c, plan, layout)

        def bwd(a, b, c):
            return TriConvBwd.apply(a, b, c, g, plan, layout)

        dg = None
        if need_g:
            dg = _add(
                None if cx is None else fwd(cx, y, w),
                None if cy is None else fwd(x, cy, w),
                None if cw is None else fwd(x, y, cw),
            )
        b1 = bwd(cx, y, w) if cx is not None and (need_y or need_w) else None  # x -> cx
        b2 = bwd(x, cy, w) if cy is not None and (need_x or need_w) else None  # y -> cy
        b3 = bwd(x, y, cw) if cw is not None and (need_x or need_y) else None  # w -> cw
        dx = _add(*(b[0] for b in (b2, b3) if b is not None)) if need_x else None
        dy = _add(*(b[1] for b in (b1, b3) if b is not None)) if need_y else None
        dw = _add(*(b[2] for b in (b1, b2) if b is not None)) if need_w else None
        return dx, dy, dw, dg, None, None


def fused_tp_scatter_mlp(plan: TPPlan, x, sh, emb, w1, w2, alpha0: float, alpha1: float,
                         layout: EdgeLayout) -> torch.Tensor:
    """Fully fused conv; ``w1``/``w2`` are the radial MLP's ``w0``/``w1``.
    Training weights (``requires_grad``) run ``FusedConv``; frozen ones,
    as in serving, the registered op ``nequip_torch::conv_fwd``, whose
    backward is K2's inference variant, then K3."""
    if w1.requires_grad or w2.requires_grad:
        return FusedConv.apply(x, sh, emb, w1, w2, plan, alpha0, alpha1, layout)
    # the layout's own tensors: a CUDA graph replayed on a layout refilled in
    # place (integrations/md.py) must read the buffers, not a copy made at capture
    tables = plan.device_tables(x.device, acc_dtype(x.dtype)).values()
    return torch.ops.nequip_torch.conv_fwd(x, sh, emb, w1, w2, layout.edge_src, layout.dst_ptr, layout.src_perm,
                                           layout.src_ptr, *tables, alpha0, alpha1)


def fused_tp_scatter(plan: TPPlan, x, edge_attr, edge_weight, layout: EdgeLayout,
                     frozen: bool = False) -> torch.Tensor:
    """The trilinear conv ``F(x, edge_attr, edge_weight)`` (K4 forward).
    Training, and any call whose layout has its real-edge count on the host
    (eager serving), runs ``TriConv``, closed under differentiation, whose
    wrappers size the carry rows by the real edges and zero only the masked
    tail.  ``frozen`` (the weights that make ``edge_weight`` need no
    gradient) with the count on the device (``n_real`` None: a traced or
    exported program) takes the registered op ``nequip_torch::tri_fwd``,
    whose backward is the inference op ``nequip_torch::tri_bwd`` (K5), then
    K3, first order only."""
    if not frozen or layout.n_real is not None:
        return TriConv.apply(x, edge_attr, edge_weight, plan, layout)
    tables = plan.device_tables(x.device, acc_dtype(x.dtype)).values()
    return torch.ops.nequip_torch.tri_fwd(x, edge_attr, edge_weight, layout.edge_src, layout.dst_ptr,
                                          layout.src_perm, layout.src_ptr, *tables)


def fused_tp_scatter_bwd(plan: TPPlan, x, edge_attr, edge_weight, layout: EdgeLayout, g):
    """``(dx, dy, dw)`` of ``F`` for the node cotangent ``g`` (K5, then K3),
    differentiable to all orders."""
    return TriConvBwd.apply(x, edge_attr, edge_weight, g, plan, layout)


# ---------------------------------------------------------------------------
# K1, K2 (inference), K3, K4 and K5 (inference) as registered ops: tensors
# and numbers in and out
# ---------------------------------------------------------------------------
_TABLES_SCHEMA = ", ".join(f"Tensor {name}" for name in TABLE_NAMES)
_COEF = [i for i, name in enumerate(TABLE_NAMES) if name.endswith("coef")]  # the float tables
_LAYOUT_SCHEMA = ", ".join(f"Tensor {name}" for name in LAYOUT_TENSORS)
_MLP_SCHEMA = "Tensor x, Tensor sh, Tensor emb, Tensor w1, Tensor w2"


def _op_layout(edge_src, dst_ptr, src_perm=None, src_ptr=None) -> EdgeLayout:
    """A layout for the plain twins inside a CPU kernel, which may read the
    real-edge count on the host."""
    return EdgeLayout(edge_src, dst_ptr, src_perm, src_ptr, n_real=int(dst_ptr[-1]))


@torch.library.custom_op(
    "nequip_torch::conv_fwd", mutates_args=(), device_types="cpu",
    schema=f"({_MLP_SCHEMA}, {_LAYOUT_SCHEMA}, {_TABLES_SCHEMA}, float alpha0, float alpha1) -> Tensor",
)
def _conv_fwd_op(x, sh, emb, w1, w2, edge_src, dst_ptr, src_perm, src_ptr, *rest):
    *tables, alpha0, alpha1 = rest
    return conv_fwd_plain(_TablePlan(dict(zip(TABLE_NAMES, tables))), x, sh, emb, w1, w2, alpha0, alpha1,
                          _op_layout(edge_src, dst_ptr, src_perm, src_ptr))


@_conv_fwd_op.register_kernel("cuda")
def _conv_fwd_cuda(x, sh, emb, w1, w2, edge_src, dst_ptr, src_perm, src_ptr, *rest):
    *tables, alpha0, alpha1 = rest
    _route("conv_fwd", x, sh, emb, w1, w2)
    _check_coefs("conv_fwd", tables, x)
    _check_index(x.device, edge_src, dst_ptr, src_perm, src_ptr)
    return _launch_conv_fwd(x, sh, emb, w1, w2, edge_src, dst_ptr, dict(zip(TABLE_NAMES, tables)), alpha0, alpha1)


@_conv_fwd_op.register_fake
def _conv_fwd_fake(x, sh, emb, w1, w2, edge_src, dst_ptr, src_perm, src_ptr, *rest):
    return x.new_empty(dst_ptr.shape[0] - 1, rest[TABLE_NAMES.index("fwd_col")].shape[0])


def _conv_fwd_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:-2])
    ctx.alphas, ctx.n_inputs = inputs[-2:], len(inputs)


def _conv_fwd_backward(ctx, g):
    """K2's inference variant, then K3 for the node cotangent of ``x``: the
    weights are frozen (training runs ``FusedConv``)."""
    if ctx.needs_input_grad[3] or ctx.needs_input_grad[4]:
        raise RuntimeError("nequip_torch::conv_fwd has no weight gradients: training runs FusedConv")
    x, sh, emb, w1, w2, edge_src, dst_ptr, src_perm, src_ptr, *tables = ctx.saved_tensors
    dx_edge, dsh, demb = _conv_bwd_op(x, sh, emb, w1, w2, g.contiguous(), edge_src, dst_ptr, *tables, *ctx.alphas)
    dx = _scatter_rows_op(dx_edge, src_perm, src_ptr) if ctx.needs_input_grad[0] else None
    return (dx, dsh, demb) + (None,) * (ctx.n_inputs - 3)


_conv_fwd_op.register_autograd(_conv_fwd_backward, setup_context=_conv_fwd_setup)


@torch.library.custom_op(
    "nequip_torch::conv_bwd", mutates_args=(), device_types="cpu",
    schema=f"({_MLP_SCHEMA}, Tensor g, Tensor edge_src, Tensor dst_ptr, {_TABLES_SCHEMA}, float alpha0, "
           "float alpha1) -> (Tensor, Tensor, Tensor)",
)
def _conv_bwd_op(x, sh, emb, w1, w2, g, edge_src, dst_ptr, *rest):
    *tables, alpha0, alpha1 = rest
    return conv_bwd_plain(_TablePlan(dict(zip(TABLE_NAMES, tables))), x, sh, emb, w1, w2, alpha0, alpha1,
                          _op_layout(edge_src, dst_ptr), g)


@_conv_bwd_op.register_kernel("cuda")
def _conv_bwd_cuda(x, sh, emb, w1, w2, g, edge_src, dst_ptr, *rest):
    *tables, alpha0, alpha1 = rest
    _route("conv_bwd", x, sh, emb, w1, w2, g)
    _check_coefs("conv_bwd", tables, x)
    _check_index(x.device, edge_src, dst_ptr)
    return _launch_conv_bwd(x, sh, emb, w1, w2, edge_src, dst_ptr, g, dict(zip(TABLE_NAMES, tables)), alpha0, alpha1)


@_conv_bwd_op.register_fake
def _conv_bwd_fake(x, sh, emb, w1, w2, g, edge_src, dst_ptr, *rest):
    return x.new_empty(sh.shape[0], x.shape[1]), torch.empty_like(sh), torch.empty_like(emb)


@torch.library.custom_op("nequip_torch::scatter_rows", mutates_args=(), device_types="cpu",
                         schema="(Tensor values, Tensor perm, Tensor ptr) -> Tensor")
def _scatter_rows_op(values, perm, ptr):
    return scatter_rows_plain(values, perm, ptr)


@_scatter_rows_op.register_kernel("cuda")
def _scatter_rows_cuda(values, perm, ptr):
    _route("scatter_rows", values)
    return _launch_scatter_rows(values, perm, ptr)


@_scatter_rows_op.register_fake
def _scatter_rows_fake(values, perm, ptr):
    return values.new_empty(ptr.shape[0] - 1, values.shape[1])


_TRI_SCHEMA = "Tensor x, Tensor y, Tensor w"


@torch.library.custom_op(
    "nequip_torch::tri_fwd", mutates_args=(), device_types="cpu",
    schema=f"({_TRI_SCHEMA}, {_LAYOUT_SCHEMA}, {_TABLES_SCHEMA}) -> Tensor",
)
def _tri_fwd_op(x, y, w, edge_src, dst_ptr, src_perm, src_ptr, *tables):
    return tri_fwd_plain(_TablePlan(dict(zip(TABLE_NAMES, tables))), x, y, w,
                         _op_layout(edge_src, dst_ptr, src_perm, src_ptr))


@_tri_fwd_op.register_kernel("cuda")
def _tri_fwd_cuda(x, y, w, edge_src, dst_ptr, src_perm, src_ptr, *tables):
    _route("tri_fwd", x, y, w)
    _check_coefs("tri_fwd", tables, x)
    _check_index(x.device, edge_src, dst_ptr, src_perm, src_ptr)
    tab = dict(zip(TABLE_NAMES, tables))
    out = torch.empty(dst_ptr.shape[0] - 1, tab["fwd_col"].shape[0], dtype=x.dtype, device=x.device)
    # carry rows over all edge slots: the real-edge count stays on the device
    _launch_tri_fwd_raw("nequip_tri_fwd", x, y, w, edge_src, dst_ptr, tab, out, y.shape[0])
    tri_fwd.launches += 1
    return out


@_tri_fwd_op.register_fake
def _tri_fwd_fake(x, y, w, edge_src, dst_ptr, src_perm, src_ptr, *tables):
    return x.new_empty(dst_ptr.shape[0] - 1, tables[TABLE_NAMES.index("fwd_col")].shape[0])


def _tri_fwd_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _tri_fwd_backward(ctx, g):
    """The inference op ``tri_bwd`` (K5), then K3 for the node cotangent of
    ``x``: first order only (training runs ``TriConv``)."""
    x, y, w, edge_src, dst_ptr, src_perm, src_ptr, *tables = ctx.saved_tensors
    dx_edge, dy, dw = _tri_bwd_op(x, y, w, g.contiguous(), edge_src, dst_ptr, *tables)
    dx = _scatter_rows_op(dx_edge, src_perm, src_ptr) if ctx.needs_input_grad[0] else None
    return (dx, dy, dw) + (None,) * (4 + len(tables))


_tri_fwd_op.register_autograd(_tri_fwd_backward, setup_context=_tri_fwd_setup)


@torch.library.custom_op(
    "nequip_torch::tri_bwd", mutates_args=(), device_types="cpu",
    schema=f"({_TRI_SCHEMA}, Tensor g, Tensor edge_src, Tensor dst_ptr, {_TABLES_SCHEMA}) "
           "-> (Tensor, Tensor, Tensor)",
)
def _tri_bwd_op(x, y, w, g, edge_src, dst_ptr, *tables):
    # K5's twin written out (``_table_tp_vjp``): a CPU kernel runs no autograd;
    # bf16 inputs run in float32 with each output rounded once
    dtype = x.dtype
    x, y, w, g = _wide(x, y, w, g)
    n = int(dst_ptr[-1])
    src = edge_src[:n].long()
    grads = _table_tp_vjp(dict(zip(TABLE_NAMES, tables)), x[src], y[:n], w[:n], g[_segment_rows(dst_ptr)])
    return tuple(F.pad(gr, (0, 0, 0, y.shape[0] - n)).to(dtype) for gr in grads)


@_tri_bwd_op.register_kernel("cuda")
def _tri_bwd_cuda(x, y, w, g, edge_src, dst_ptr, *tables):
    _route("tri_bwd", x, y, w, g)
    _check_coefs("tri_bwd", tables, x)
    _check_index(x.device, edge_src, dst_ptr)
    # zeroed whole: the kernel writes the real slots, whose count stays on the device
    outs = tuple(torch.zeros(y.shape[0], width, dtype=x.dtype, device=x.device)
                 for width in (x.shape[1], y.shape[1], w.shape[1]))
    _launch_tri_bwd_raw(x, y, w, edge_src, dst_ptr, g, dict(zip(TABLE_NAMES, tables)), outs)
    tri_bwd.launches += 1
    return outs


@_tri_bwd_op.register_fake
def _tri_bwd_fake(x, y, w, g, edge_src, dst_ptr, *tables):
    return x.new_empty(y.shape[0], x.shape[1]), torch.empty_like(y), torch.empty_like(w)


# ---------------------------------------------------------------------------
# the edge-chunked convolutions of fr training (first order only)
# ---------------------------------------------------------------------------
def _mlp(mlp, weights, emb):
    """The radial MLP on ``emb`` with ``weights`` cast to ``emb``'s dtype at
    use: a bf16 model's weights are float32 parameters, and their
    gradients land in float32."""
    return mlp.with_weights(emb, [w.to(emb.dtype) for w in weights])


def _mlp_jvp(mlp, weights, emb, temb):
    """``(w, dw) = jvp(MLP)(emb; temb)`` in plain torch.  ``torch.func.jvp``
    works inside an autograd Function's forward (where forward-mode dual
    tensors do not), and reverse mode differentiates through both outputs."""
    w, dw = torch.func.jvp(lambda e: _mlp(mlp, weights, e), (emb,), (temb,))
    return w.contiguous(), dw.contiguous()


def _slice_acc(x, plan: TPPlan, n: int = 1):
    """The accumulators the first slice of an edge-sliced conv starts from:
    none in float32 and float64 (the first slice's kernel writes its own
    output), float32 zeros for bf16 inputs, so that the sum over the slices
    is rounded to bf16 once, after the last (``.to(x.dtype)``)."""
    if x.dtype != torch.bfloat16:
        return None
    acc = tuple(torch.zeros(x.shape[0], plan.mid_dim, dtype=acc_dtype(x.dtype), device=x.device) for _ in range(n))
    return acc[0] if n == 1 else acc


def _slice_inputs(need, ts, weights, rows):
    """Slice rows of per-edge ``ts`` and the MLP weights as graph leaves,
    each requiring grad where ``need`` says so."""
    return (
        [t[rows].detach().requires_grad_(nd) for t, nd in zip(ts, need)],
        [w.detach().requires_grad_(nd) for w, nd in zip(weights, need[len(ts):])],
    )


def _mlp_vjp(outs, cts, leaves, grads):
    """Add the VJP of ``outs`` at ``cts`` into ``grads`` (in place, leaf by
    leaf; None where a leaf needs no grad)."""
    wrt = [(i, t) for i, t in enumerate(leaves) if t.requires_grad]
    if not wrt:
        return
    found = torch.autograd.grad(outs, [t for _, t in wrt], cts, allow_unused=True)
    for (i, _), gr in zip(wrt, found):
        if gr is not None:
            grads[i].add_(gr)


class ChunkedConv(torch.autograd.Function):
    """The primal conv ``scatter_dst(TP(x[src], sh, MLP(emb)))`` over the
    slices of ``layout.slices(C)`` (JAX ``chunked_conv``): per slice, the
    radial MLP in plain torch, then K4 for the first slice and K4-acc for
    the others, so ``[E, WN]`` weights exist one slice at a time.  bf16:
    K4-acc for every slice onto a float32 accumulator, rounded to bf16 once
    after the last (JAX keeps its accumulator in bf16).  Backward, per
    slice: recompute the slice's weights, K5, K3 for ``dx``, and the MLP's
    VJP; node cotangents (``acc_dtype``) and weight gradients (the weights'
    dtype) are summed in place in slice order.  First order only, as in
    JAX."""

    @staticmethod
    def forward(ctx, x, sh, emb, plan, mlp, slices, *weights):
        ctx.plan, ctx.mlp, ctx.slices = plan, mlp, slices
        ctx.save_for_backward(x, sh, emb, *weights)
        msg = _slice_acc(x, plan)
        for sl in slices:
            rows = slice(sl.start, sl.stop)
            w_s = _mlp(mlp, weights, emb[rows]).contiguous()
            msg = tri_fwd(plan, x, sh[rows], w_s, sl.layout, acc=msg)
        return msg.to(x.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, sh, emb, *weights = ctx.saved_tensors
        need = ctx.needs_input_grad
        plan, g = ctx.plan, g.contiguous()
        dx = torch.zeros_like(x, dtype=acc_dtype(x.dtype))
        dsh, demb = torch.zeros_like(sh), torch.zeros_like(emb)
        dws = [torch.zeros_like(w) for w in weights]
        for sl in ctx.slices:
            rows = slice(sl.start, sl.stop)
            with torch.enable_grad():
                (e_s,), ws = _slice_inputs((need[2],) + need[6:], (emb,), weights, rows)
                w_s = _mlp(ctx.mlp, ws, e_s)
            dx_e, dsh_s, dw_s = tri_bwd(plan, x, sh[rows], w_s.detach().contiguous(), sl.layout, g)
            if need[0]:
                dx.add_(scatter_rows(dx_e, sl.layout.src_perm, sl.layout.src_ptr))
            dsh[rows] = dsh_s
            demb_s = torch.zeros_like(e_s)
            _mlp_vjp(w_s, dw_s, [e_s] + ws, [demb_s] + dws)
            demb[rows] = demb_s
        dx = dx.to(x.dtype)
        return (dx if need[0] else None, dsh if need[1] else None, demb if need[2] else None,
                None, None, None, *(d if nd else None for d, nd in zip(dws, need[6:])))


class ChunkedJvpConv(torch.autograd.Function):
    """The conv and its tangent over the slices of ``layout.slices(C)`` (JAX
    ``chunked_jvp_conv``, the edge-chunked dual sweep of fr training):

        msg  = F(x, sh, w),  tmsg = F(tx, sh, w) + F(x, tsh, w) + F(x, sh, dw),
        (w, dw) = jvp(MLP)(emb; temb)

    Forward, per slice: ``(w_s, dw_s)`` in plain torch, then K6 (its
    accumulating form after the first slice; bf16: for every slice, onto
    float32 accumulators rounded to bf16 once after the last).  Backward,
    per slice: recompute ``(w_s, dw_s)``, K7, K3 for ``dx`` and for
    ``dtx``, and the reverse of the MLP jvp with respect to ``emb``,
    ``temb`` and the MLP weights.  Node cotangents (``acc_dtype``) and
    weight gradients are summed in place in slice order; per-edge
    cotangents fill their slice's rows.  First order only, as in JAX."""

    @staticmethod
    def forward(ctx, x, tx, sh, tsh, emb, temb, plan, mlp, slices, *weights):
        ctx.plan, ctx.mlp, ctx.slices = plan, mlp, slices
        ctx.save_for_backward(x, tx, sh, tsh, emb, temb, *weights)
        acc = _slice_acc(x, plan, 2)
        for sl in slices:
            rows = slice(sl.start, sl.stop)
            w_s, dw_s = _mlp_jvp(mlp, weights, emb[rows], temb[rows])
            acc = jvp_fwd(plan, x, tx, sh[rows], tsh[rows], w_s, dw_s, sl.layout, acc=acc)
        return tuple(a.to(x.dtype) for a in acc)

    @staticmethod
    @once_differentiable
    def backward(ctx, g, gt):
        x, tx, sh, tsh, emb, temb, *weights = ctx.saved_tensors
        need = ctx.needs_input_grad
        plan, g, gt = ctx.plan, g.contiguous(), gt.contiguous()
        dx, dtx = (torch.zeros_like(t, dtype=acc_dtype(t.dtype)) for t in (x, tx))
        dsh, dtsh = torch.zeros_like(sh), torch.zeros_like(tsh)
        demb, dtemb = torch.zeros_like(emb), torch.zeros_like(temb)
        dws = [torch.zeros_like(w) for w in weights]
        for sl in ctx.slices:
            rows = slice(sl.start, sl.stop)
            with torch.enable_grad():
                (e_s, te_s), ws = _slice_inputs((need[4], need[5]) + need[9:], (emb, temb), weights, rows)
                w_s, dw_s = _mlp_jvp(ctx.mlp, ws, e_s, te_s)
            dx_e, dtx_e, dsh[rows], dtsh[rows], cw, cdw = jvp_bwd(
                plan, x, tx, sh[rows], tsh[rows], w_s.detach(), dw_s.detach(), sl.layout, g, gt
            )
            lay = sl.layout
            if need[0]:
                dx.add_(scatter_rows(dx_e, lay.src_perm, lay.src_ptr))
            if need[1]:
                dtx.add_(scatter_rows(dtx_e, lay.src_perm, lay.src_ptr))
            demb_s, dtemb_s = torch.zeros_like(e_s), torch.zeros_like(te_s)
            _mlp_vjp((w_s, dw_s), (cw, cdw), [e_s, te_s] + ws, [demb_s, dtemb_s] + dws)
            demb[rows], dtemb[rows] = demb_s, dtemb_s
        grads = (dx.to(x.dtype), dtx.to(tx.dtype), dsh, dtsh, demb, dtemb)
        return (*(gr if nd else None for gr, nd in zip(grads, need[:6])), None, None, None,
                *(d if nd else None for d, nd in zip(dws, need[9:])))


def chunked_conv(plan: TPPlan, mlp, x, sh, emb, layout: EdgeLayout, n_chunks: int) -> torch.Tensor:
    """``ChunkedConv`` over ``n_chunks`` slices of the stream; ``mlp`` is the
    block's radial ``ops.mlp.ScalarMLP``, whose weights enter as they are
    (float32 in a bf16 model) and are cast at use."""
    return ChunkedConv.apply(x, sh, emb, plan, mlp, layout.slices(n_chunks), *mlp.weights())


def chunked_jvp_conv(plan: TPPlan, mlp, x, tx, sh, tsh, emb, temb, layout: EdgeLayout, n_chunks: int):
    """``ChunkedJvpConv`` over ``n_chunks`` slices of the stream:
    ``(msg, tmsg)``."""
    return ChunkedJvpConv.apply(x, tx, sh, tsh, emb, temb, plan, mlp, layout.slices(n_chunks), *mlp.weights())
