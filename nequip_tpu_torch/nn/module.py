"""Graph modules: irreps bookkeeping on ``torch.nn.Module``.

Port of ``nequip_tpu/nn/module.py``.  A module checks irreps compatibility
when it is built and maps a data dict (AtomicDataDict of tensors) to a new
data dict in ``forward``.  Parameters are ``nn.Parameter``s named so that
the dotted paths of a model match the JAX package's parameter tree
(``model/jax_params.py``); frozen JAX parameters are persistent buffers.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

import torch
import torch.autograd.forward_ad as fwAD
from torch import nn

from ..ops.irreps import Irreps
from ..utils.dtype import get_default_dtype

IrrepsDict = Dict[str, Optional[Irreps]]


def _norm_irreps(v):
    return None if v is None else Irreps(v)


class GraphModule(nn.Module):
    """Base class: irreps metadata + ``forward(data) -> data``.

    ``_jax_transparent`` names child modules whose parameters sit directly
    under this module's path in the JAX parameter tree.
    """

    _jax_transparent: Tuple[str, ...] = ()

    def __init__(self):
        super().__init__()
        self.irreps_in: IrrepsDict = {}
        self.irreps_out: IrrepsDict = {}
        self.model_dtype = get_default_dtype()

    def _init_irreps(
        self,
        irreps_in: Optional[Mapping] = None,
        my_irreps_in: Optional[Mapping] = None,
        required_irreps_in: Sequence[str] = (),
        irreps_out: Optional[Mapping] = None,
    ) -> None:
        irreps_in = {k: _norm_irreps(v) for k, v in dict(irreps_in or {}).items()}
        for k, v in dict(my_irreps_in or {}).items():
            v = _norm_irreps(v)
            if k in irreps_in:
                if v is not None and irreps_in[k] != v:
                    raise ValueError(
                        f"{type(self).__name__}: input {k} has irreps {irreps_in[k]} but {v} is required"
                    )
            else:
                irreps_in[k] = v
        for k in required_irreps_in:
            if k not in irreps_in:
                raise ValueError(
                    f"{type(self).__name__}: required input field {k!r} missing from {sorted(irreps_in)}"
                )
        self.irreps_in = irreps_in
        self.irreps_out = dict(irreps_in)
        self.irreps_out.update({k: _norm_irreps(v) for k, v in dict(irreps_out or {}).items()})

    def metadata(self) -> Dict[str, str]:
        return {}

    def jvp(self, data: dict, tangents: dict) -> Tuple[dict, dict]:
        """``(out, tangent_out)``: one dual-number step of this module (the
        JAX ``GraphModule.jvp``).

        ``tangents`` maps some float fields of ``data`` to tangents (a
        missing key is a zero tangent).  The default runs ``forward`` on
        forward-mode dual tensors (``torch.autograd.forward_ad``), which is
        right for any module built from plain torch ops; reverse mode then
        differentiates the tangents with respect to the parameters
        (reverse over forward).  Modules that call the CUDA kernels override
        it with a hand-written rule (``InteractionBlock.jvp``), so forward
        mode never enters a kernel.  Outputs that do not depend on the
        tangents get no tangent (JAX returns dense zeros there).
        """
        keys = [k for k in data if k in tangents]
        if not keys:
            return self(data), {}
        with fwAD.dual_level():
            inner = dict(data)
            inner.update({k: fwAD.make_dual(data[k], tangents[k]) for k in keys})
            out, t_out = {}, {}
            for k, v in self(inner).items():
                if isinstance(v, torch.Tensor) and v.is_floating_point():
                    out[k], t = fwAD.unpack_dual(v)
                    if t is not None:
                        t_out[k] = t
                else:
                    out[k] = v
        return out, t_out

    def jax_named_tensors(self, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
        """(JAX dotted path, tensor) for every parameter and persistent buffer."""
        for name, p in self.named_parameters(recurse=False):
            yield prefix + name, p
        for name, b in self.named_buffers(recurse=False):
            if name not in self._non_persistent_buffers_set:
                yield prefix + name, b
        for name, child in self.named_children():
            child_prefix = prefix if name in self._jax_transparent else f"{prefix}{name}."
            if isinstance(child, GraphModule):
                yield from child.jax_named_tensors(child_prefix)
            else:
                for pname, p in child.named_parameters():
                    yield child_prefix + pname, p
                for bname, b in child.named_buffers():
                    yield child_prefix + bname, b


class SequentialGraphNetwork(GraphModule):
    """Ordered container with construction-time irreps chaining."""

    def __init__(self, modules: Mapping[str, GraphModule]):
        super().__init__()
        names = list(modules)
        for prev, nxt in zip(names, names[1:]):
            self._check_pair(modules[prev], modules[nxt], nxt)
        for name, m in modules.items():
            self.add_module(name, m)
        self.irreps_in = dict(modules[names[0]].irreps_in)
        self.irreps_out = dict(modules[names[-1]].irreps_out)

    @staticmethod
    def _check_pair(prev: GraphModule, nxt: GraphModule, name: str) -> None:
        for k, v in nxt.irreps_in.items():
            pv = prev.irreps_out.get(k)
            if v is not None and pv is not None and v != pv:
                raise ValueError(f"irreps mismatch into module {name!r} for field {k!r}: {pv} vs {v}")

    def append(self, name: str, module: GraphModule) -> None:
        last = list(self.children())[-1]
        self._check_pair(last, module, name)
        self.add_module(name, module)
        self.irreps_out = dict(module.irreps_out)

    def forward(self, data: dict) -> dict:
        for module in self.children():
            data = module(data)
        return data

    def jvp(self, data: dict, tangents: dict) -> Tuple[dict, dict]:
        tangents = dict(tangents)
        for module in self.children():
            data, tangents = module.jvp(data, tangents)
        return data, tangents

    def metadata(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for m in self.children():
            out.update(m.metadata())
        return out


def replace_submodules(module: nn.Module, cls, factory) -> nn.Module:
    """Replace every submodule of type ``cls`` (the module itself too) by
    ``factory(old)``, recursively, in place (JAX ``replace_submodules``).
    The parameters of a replaced module go with it."""
    if isinstance(module, cls):
        return factory(module)
    for name, child in list(module.named_children()):
        setattr(module, name, replace_submodules(child, cls, factory))
    return module
