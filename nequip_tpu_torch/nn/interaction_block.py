"""The NequIP message-passing interaction block.

Port of ``InteractionBlock.__call__`` (``nequip_tpu/nn/interaction_block.py``):

    linear_1 -> avg-num-neighbor norm -> TP-scatter with radial-MLP edge
    weights -> merge of same-irrep mid chunks -> linear_2 -> + self-connection

The conv runs one of three routes (``InteractionBlock.route``), fixed when
the implementation is set, by the JAX package's own rule
(``use_fully_fused``):

* ``"fused"`` (K1, backward K2 and K3): ``tp_impl="fused"`` with the
  depth-1, bias-free silu radial MLP that K1 computes in-kernel; the
  ``[E, weight_numel]`` radial weights never exist in device memory;
* ``"fused_tp"`` (K4, backward K5 and K3): ``tp_impl="fused_tp"``, and
  ``tp_impl="fused"`` with any other radial MLP (JAX ``pallas_fused`` runs
  such an MLP in XLA and the TP-scatter after it): the MLP runs in plain
  PyTorch and the trilinear kernel takes its output;
* ``"torch"``: the plain PyTorch path.

fr (reverse-over-forward) training hands the block ``fr_edge_chunks = C``
(``train/training_module.py``, ``edge_chunks``); with ``C > 1`` and either
kernel impl, ``forward`` runs the conv over C slices of the edge stream
(``ChunkedConv``: K4-acc, backward K5 + K3) and ``jvp`` runs the dual
sweep over them (``ChunkedJvpConv``: K6, backward K7 + K3).

``forward`` is ``tail(conv(head(data)))``: ``ConvNetLayer``'s
``remat="save_tp"`` checkpoints the head and the tail and keeps the conv's
output, so the kernel is not run again in the backward.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..data import _keys
from ..ops.irreps import Irreps
from ..ops.kernels.tp_scatter import (
    LAYOUT_KEY,
    chunked_conv,
    chunked_jvp_conv,
    fused_tp_scatter,
    fused_tp_scatter_mlp,
)
from ..ops.linear import Linear
from ..ops.mlp import ScalarMLP as ScalarMLPFunction
from ..ops.tensor_product import fully_connected_tensor_product, uvu_instructions
from .module import GraphModule
from .norm import AvgNumNeighborsNorm
from .tp_scatter import KERNEL_IMPLS, TensorProductScatter


def merge_mid_permutation(irreps_mid: Irreps) -> np.ndarray:
    """Column permutation taking uncoalesced mid chunks (same irrep, adjacent)
    to the simplified layout ``linear_2`` expects: merged[..., i] =
    x[..., perm[i]].  The same static map as the JAX ``_merge_mid_impl``."""
    cols = np.arange(irreps_mid.dim)
    slices = irreps_mid.slices()
    out = []
    i = 0
    while i < len(irreps_mid):
        ir = irreps_mid[i].ir
        group = []
        while i < len(irreps_mid) and irreps_mid[i].ir == ir:
            group.append(cols[slices[i]].reshape(ir.dim, irreps_mid[i].mul))
            i += 1
        out.append(np.concatenate(group, axis=-1).reshape(-1))
    return np.concatenate(out)


class InteractionBlock(GraphModule):
    def __init__(
        self,
        irreps_in,
        irreps_out,
        radial_mlp_depth: int = 1,
        radial_mlp_width: int = 8,
        use_sc: bool = True,
        is_first_layer: bool = False,
        type_names: Optional[Sequence[str]] = None,
        avg_num_neighbors: Optional[Union[float, Dict[str, float]]] = None,
        tp_impl: str = "torch",
    ):
        super().__init__()
        self._init_irreps(
            irreps_in=irreps_in,
            required_irreps_in=[
                _keys.EDGE_EMBEDDING_KEY,
                _keys.EDGE_ATTRS_KEY,
                _keys.NODE_FEATURES_KEY,
                _keys.NODE_ATTRS_KEY,
            ],
            irreps_out={_keys.NODE_FEATURES_KEY: Irreps(irreps_out)},
        )
        edge_emb_irreps = self.irreps_in[_keys.EDGE_EMBEDDING_KEY]
        if not all(mi.ir.l == 0 and mi.ir.p == 1 for mi in edge_emb_irreps):
            raise ValueError(f"edge embedding must be 0e scalars, got {edge_emb_irreps}")
        self.use_sc = use_sc
        self.is_first_layer = is_first_layer
        feature_irreps_in = self.irreps_in[_keys.NODE_FEATURES_KEY]
        feature_irreps_out = self.irreps_out[_keys.NODE_FEATURES_KEY]
        irreps_edge_attr = self.irreps_in[_keys.EDGE_ATTRS_KEY]

        self.avg_num_neighbors_norm = AvgNumNeighborsNorm(
            avg_num_neighbors=avg_num_neighbors, type_names=type_names, irreps_in=self.irreps_in
        )
        self.linear_1 = Linear(feature_irreps_in, feature_irreps_in)
        irreps_mid, instructions = uvu_instructions(feature_irreps_in, irreps_edge_attr, feature_irreps_out)
        self.tp_scatter = TensorProductScatter(
            feature_irreps_in, irreps_edge_attr, irreps_mid, instructions, impl=tp_impl
        )
        self.edge_mlp = ScalarMLPFunction(
            input_dim=edge_emb_irreps.num_irreps,
            output_dim=self.tp_scatter.weight_numel,
            hidden_layers_depth=radial_mlp_depth,
            hidden_layers_width=radial_mlp_width,
            nonlinearity="silu",
        )
        self.set_tp_impl(tp_impl)
        self.irreps_mid = irreps_mid
        self.irreps_mid_simplified = irreps_mid.simplify()
        self._merge_perm = (
            merge_mid_permutation(irreps_mid)
            if len(self.irreps_mid_simplified) != len(irreps_mid)
            else None
        )
        self._merge_perms: Dict[torch.device, torch.Tensor] = {}  # _merge_perm, per device
        self.linear_2 = Linear(self.irreps_mid_simplified, feature_irreps_out)
        # self-connection TP; its shared weights are the parameter ``sc``
        self.sc_tp = (
            fully_connected_tensor_product(
                feature_irreps_in, self.irreps_in[_keys.NODE_ATTRS_KEY], feature_irreps_out
            )
            if use_sc
            else None
        )
        if self.sc_tp is not None:
            self.sc = nn.Parameter(torch.empty(self.sc_tp.weight_numel, dtype=self.model_dtype))
        # edge slices of the fr sweep; set by the fr train step, 0 otherwise
        self.fr_edge_chunks = 0

    def set_tp_impl(self, tp_impl: str) -> None:
        """Switch the conv's implementation (``TP_IMPLS``); the weights stay.
        ``route`` says which kernels the conv runs (module docstring)."""
        self.tp_scatter.set_impl(tp_impl)
        mlp = self.edge_mlp
        k1_mlp = (mlp.num_layers == 2 and not mlp.bias and mlp.nonlinearity == "silu"
                  and mlp.parametrization is None)
        self.route = "fused_tp" if tp_impl == "fused" and not k1_mlp else tp_impl

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.sc_tp is not None:
            self.sc.copy_(torch.randn(self.sc.shape, generator=generator, dtype=torch.float64))

    def _merge_mid(self, x: torch.Tensor) -> torch.Tensor:
        if self._merge_perm is None:
            return x
        if x.device not in self._merge_perms:
            self._merge_perms[x.device] = torch.as_tensor(self._merge_perm, device=x.device)
        return torch.index_select(x, -1, self._merge_perms[x.device])

    def head(self, data: dict):
        """``(x, sc)``: the normed ``linear_1`` features and the
        self-connection (None without one)."""
        x = data[_keys.NODE_FEATURES_KEY]
        sc = self.sc_tp(x, data[_keys.NODE_ATTRS_KEY], self.sc.to(x.dtype)) if self.sc_tp is not None else None
        return self._feature_maps(data, self.linear_1(x)), sc

    def conv(self, data: dict, x: torch.Tensor) -> torch.Tensor:
        """The ``[N, mid_dim]`` messages of the route's kernels."""
        emb, sh = data[_keys.EDGE_EMBEDDING_KEY], data[_keys.EDGE_ATTRS_KEY]
        if self._chunked():
            return chunked_conv(self.tp_scatter.plan, self.edge_mlp, x, sh, emb, data[LAYOUT_KEY],
                                self.fr_edge_chunks)
        if self.route == "fused":
            return fused_tp_scatter_mlp(
                self.tp_scatter.plan, x, sh, emb, self.edge_mlp.w0.to(x.dtype), self.edge_mlp.w1.to(x.dtype),
                self.edge_mlp.alphas[0], self.edge_mlp.alphas[1], data[LAYOUT_KEY],
            )
        if self.route == "fused_tp":
            return fused_tp_scatter(self.tp_scatter.plan, x, sh, self.edge_mlp(emb), data[LAYOUT_KEY],
                                    frozen=self._frozen())
        return self.tp_scatter.forward_tp_scatter(
            x=x,
            edge_attr=sh,
            edge_weight=self.edge_mlp(emb),
            edge_dst=data[_keys.EDGE_INDEX_KEY][0],
            edge_src=data[_keys.EDGE_INDEX_KEY][1],
            edge_mask=data.get(_keys.EDGE_MASK_KEY),
            num_nodes=x.shape[0],
        )

    def tail(self, msg: torch.Tensor, sc: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.linear_2(self._merge_mid(msg))
        return x if sc is None else x + sc

    def forward(self, data: dict) -> dict:
        x, sc = self.head(data)
        data = dict(data)
        data[_keys.NODE_FEATURES_KEY] = self.tail(self.conv(data, x), sc)
        return data

    def _frozen(self) -> bool:
        """Serving: no radial-MLP weight needs a gradient, so the K4 route
        takes its registered ops (first order only)."""
        return not any(w.requires_grad for w in self.edge_mlp.weights())

    def _chunked(self) -> bool:
        return self.fr_edge_chunks > 1 and self.tp_scatter.impl in KERNEL_IMPLS

    def _feature_maps(self, data: dict, feats: torch.Tensor) -> torch.Tensor:
        """The neighbour norm, linear in the features (applied to tangents too)."""
        return self.avg_num_neighbors_norm(dict(data, **{_keys.NODE_FEATURES_KEY: feats}))[_keys.NODE_FEATURES_KEY]

    def jvp(self, data: dict, tangents: dict):
        """Hand-written forward-mode rule (JAX ``InteractionBlock.jvp``).

        The conv is trilinear in (node features, SH, radial weights), so its
        tangent is three calls of the same kernels that compute the primal,

            d msg = F(tx, sh, w) + F(x, tsh, w) + F(x, sh, dw),
            (w, dw) = jvp(MLP)(emb; temb)  (plain torch),

        each a ``torch.autograd.Function`` that reverse mode differentiates;
        with ``fr_edge_chunks > 1`` the whole sweep runs over edge slices in
        ``ChunkedJvpConv`` (K6/K7).  The linears, the norm and the
        self-connection are linear in the features and take the tangent
        through the same maps.  Forward mode never enters a kernel.
        """
        x = data[_keys.NODE_FEATURES_KEY]
        tx = tangents.get(_keys.NODE_FEATURES_KEY)
        n_attrs = data[_keys.NODE_ATTRS_KEY]
        t_attrs = tangents.get(_keys.NODE_ATTRS_KEY)
        t_sc = None
        if self.sc_tp is not None:
            w_sc = self.sc.to(x.dtype)
            sc = self.sc_tp(x, n_attrs, w_sc)
            terms = ([self.sc_tp(tx, n_attrs, w_sc)] if tx is not None else []) + (
                [self.sc_tp(x, t_attrs, w_sc)] if t_attrs is not None else [])
            t_sc = _sum(terms)

        x = self._feature_maps(data, self.linear_1(x))
        if tx is not None:
            tx = self._feature_maps(data, self.linear_1(tx))
        sh, tsh = data[_keys.EDGE_ATTRS_KEY], tangents.get(_keys.EDGE_ATTRS_KEY)
        emb, temb = data[_keys.EDGE_EMBEDDING_KEY], tangents.get(_keys.EDGE_EMBEDDING_KEY)
        impl, plan, frozen = self.route, self.tp_scatter.plan, self._frozen()
        weights = [w.to(x.dtype) for w in self.edge_mlp.weights()]

        if self._chunked():
            # a missing tangent is zero (the JAX sweep sees dense zeros there)
            tx_, tsh_, temb_ = (torch.zeros_like(p) if t is None else t
                                for p, t in ((x, tx), (sh, tsh), (emb, temb)))
            msg, tmsg = chunked_jvp_conv(plan, self.edge_mlp, x, tx_, sh, tsh_, emb, temb_,
                                         data[LAYOUT_KEY], self.fr_edge_chunks)
        else:
            if impl == "fused":
                a0, a1 = self.edge_mlp.alphas

                def K(xx, ss, ww=None):
                    if ww is not None:  # the dw term: the trilinear kernel (K4)
                        return fused_tp_scatter(plan, xx, ss, ww, data[LAYOUT_KEY], frozen=frozen)
                    return fused_tp_scatter_mlp(plan, xx, ss, emb, *weights, a0, a1, data[LAYOUT_KEY])
            elif impl == "fused_tp":
                w = self.edge_mlp.with_weights(emb, weights)

                def K(xx, ss, ww=None):
                    return fused_tp_scatter(plan, xx, ss, w if ww is None else ww, data[LAYOUT_KEY],
                                            frozen=frozen)
            else:
                w = self.edge_mlp.with_weights(emb, weights)

                def K(xx, ss, ww=None):
                    return self.tp_scatter.forward_tp_scatter(
                        x=xx, edge_attr=ss, edge_weight=w if ww is None else ww,
                        edge_dst=data[_keys.EDGE_INDEX_KEY][0], edge_src=data[_keys.EDGE_INDEX_KEY][1],
                        edge_mask=data.get(_keys.EDGE_MASK_KEY), num_nodes=x.shape[0],
                    )

            msg = K(x, sh)
            terms = []
            if tx is not None:
                terms.append(K(tx, sh))
            if tsh is not None:
                terms.append(K(x, tsh))
            if temb is not None:
                _, dw = torch.func.jvp(lambda e: self.edge_mlp.with_weights(e, weights), (emb,), (temb,))
                terms.append(K(x, sh, dw.contiguous()))
            tmsg = _sum(terms)

        x_out = self.linear_2(self._merge_mid(msg))
        tx_out = None if tmsg is None else self.linear_2(self._merge_mid(tmsg))
        if self.sc_tp is not None:
            x_out = x_out + sc
            if t_sc is not None:
                tx_out = t_sc if tx_out is None else tx_out + t_sc
        out = dict(data)
        out[_keys.NODE_FEATURES_KEY] = x_out
        t_out = dict(tangents)
        if tx_out is not None:
            t_out[_keys.NODE_FEATURES_KEY] = tx_out
        else:
            t_out.pop(_keys.NODE_FEATURES_KEY, None)
        return out, t_out


def _sum(terms):
    """Sum of a list of tensors in order (None if empty)."""
    return sum(terms[1:], terms[0]) if terms else None
