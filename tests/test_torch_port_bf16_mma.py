"""The arithmetic of the bf16 W2 products on the tensor cores, on the CPU.

K2's bf16 form (``csrc/conv_bwd.cu``, ``radial_mlp.cuh`` ``tile_mma``) runs
``dh = dW_e . W2^T`` as bf16 ``mma.sync`` with float32 accumulators.  dW_e
is a float32 tile (its rounding point), so each value enters as two bf16
terms, ``hi = bf16(dW_e)`` and ``lo = bf16(dW_e - hi)``, two MMAs into the
same accumulators.  K1's bf16 form (``csrc/conv_fwd.cu``) runs ``w = alpha1
h . W2`` the same way, with h the float32 hidden layer.  These tests model
that product in numpy as the card takes it: every product exact, each k16
step's 16 products summed and rounded to float32, then added onto a float32
accumulator.

* (a) At K2's widths the two-term product stays within 1e-4 of max|product|
  (the f32 kernels' gate) of the float64 product; the measured ratio is
  printed beside that of ``hi`` alone.
* (b) A twin of ``conv_bwd_train_plain`` with that product in place of its
  float32 ``dh`` product gives demb and dw1 (the outputs that read dh)
  within K2's bf16 twin gate (8e-3 of max|out|), the gate that
  ``chip_smoke.py`` phase 16a holds the kernel to.

* K1 (a): ``alpha1 h . W2`` with h split hi + lo stays within 1e-4 of
  max|product| of the float64 product.
* K1 (b): a twin of ``conv_fwd_plain`` with that product in place of its
  float32 w product gives ``out`` within phase 16a's gate (8e-3 of
  max|out|) of ``conv_fwd_plain``'s; the share of w entries that round to
  another bf16 value is printed.

Each is parametrised over the flagship's three conv layers (WN 96, 352,
96) and preset M's widest (WN 768), hidden 128.
"""

import numpy as np
import pytest
import torch

from nequip_tpu_torch.data import _keys
from nequip_tpu_torch.model import NequIPGNNModel, PresetNequIPGNNModel
from nequip_tpu_torch.nn.interaction_block import InteractionBlock
from nequip_tpu_torch.ops.kernels import tp_scatter as K

F32_GATE = 1e-4  # of max|product|: the f32 kernels against plain
TWIN_GATE = 8e-3  # of max|out|: K2's bf16 form against its twin (chip_smoke.py BF16_KERNEL_TOL)
SHAPES = {"flagship_layer0": ("flagship", 0), "flagship_layer1": ("flagship", 1), "flagship_layer2": ("flagship", 2),
          "preset_m_layer1": ("preset_m", 1)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops: one intra-op thread keeps them fast beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def blocks():
    """The conv layers of the flagship and of preset M (float32 weights)."""
    flagship = NequIPGNNModel(seed=0, model_dtype="float32", type_names=["Cu"], r_max=4.0, num_layers=3, l_max=2,
                              parity=False, num_features=32, avg_num_neighbors=18.0, tp_impl="fused")
    preset_m = PresetNequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", type_names=["Cu"], r_max=4.0,
                                    preset="M", avg_num_neighbors=18.0)
    return {name: [m for m in model.modules() if isinstance(m, InteractionBlock)]
            for name, model in (("flagship", flagship), ("preset_m", preset_m))}


def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bf16 (ties to even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).bfloat16().float().numpy()


def card_product(a: np.ndarray, b: np.ndarray, terms=("hi", "lo")) -> np.ndarray:
    """a [n, k] float32 . b [k, m] (bf16 values) as the tensor cores take it:
    a as bf16 terms (hi, and lo = bf16(a - hi)), per k16 step one MMA a
    term, each the exact sum of its 16 products rounded to float32 and added
    onto a float32 accumulator."""
    hi = _bf16(a)
    split = {"hi": hi, "lo": _bf16(a - hi)}
    k = a.shape[1]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    b64 = b.astype(np.float64)
    for k0 in range(0, k, 16):
        for t in terms:
            step = (split[t][:, k0:k0 + 16].astype(np.float64) @ b64[k0:k0 + 16]).astype(np.float32)
            acc = acc + step  # float32 + float32, rounded once
    return acc


def _layer(blocks, shape):
    model, li = SHAPES[shape]
    blk = blocks[model][li]
    return blk.tp_scatter.plan, blk.edge_mlp.w0.shape, blk.edge_mlp.alphas


@pytest.mark.parametrize("shape", list(SHAPES))
def test_split_product_keeps_float32_gate(blocks, shape):
    """(a) dW_e . W2^T from the two bf16 terms of float32 dW_e, against the
    float64 product, within 1e-4 of max|product|."""
    plan, (_, hidden), _ = _layer(blocks, shape)
    wn = plan.weight_numel
    r = np.random.RandomState(24)
    dw_e = r.standard_normal((256, wn)).astype(np.float32)
    w2t = _bf16(r.standard_normal((wn, hidden)))
    exact = dw_e.astype(np.float64) @ w2t.astype(np.float64)
    scale = float(np.abs(exact).max())
    err = float(np.abs(card_product(dw_e, w2t) - exact).max()) / scale
    hi_only = float(np.abs(card_product(dw_e, w2t, terms=("hi",)) - exact).max()) / scale
    print(f"{shape}: WN {wn}, hidden {hidden}: hi + lo {err:.3e} of max|product|, hi alone {hi_only:.3e} "
          f"(gate {F32_GATE:.0e})")
    assert err <= F32_GATE


def _stream(device, r, n_nodes=24, n_slots=256, n_real=200):
    ei = np.stack([r.randint(0, n_nodes, n_slots), r.randint(0, n_nodes, n_slots)])
    data = K.relayout_edge_stream({
        _keys.POSITIONS_KEY: torch.zeros(n_nodes, 3, device=device),
        _keys.EDGE_INDEX_KEY: torch.as_tensor(ei, device=device),
        _keys.EDGE_MASK_KEY: torch.as_tensor(np.arange(n_slots) < n_real, device=device),
    })
    return data[K.LAYOUT_KEY]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_conv_bwd_twin_with_split_product_keeps_gate(blocks, shape):
    """(b) K2's training twin in bf16 with dh = dW_e . W2^T taken as the card
    takes it (float32 dW_e as hi + lo, W2^T bf16, float32 sums per k16
    step, then alpha1 and silu'): its demb and dw1 within 8e-3 of
    max|out| of conv_bwd_train_plain's."""
    plan, (n_emb, hidden), (a0, a1) = _layer(blocks, shape)
    r = np.random.RandomState(25)
    lay = _stream("cpu", r)
    n_nodes, n_slots, n = lay.num_nodes, 256, lay.n_real
    t = lambda *s: torch.as_tensor(r.standard_normal(s), dtype=torch.bfloat16)  # noqa: E731
    x, sh, emb, w1, w2, g = (t(n_nodes, plan.dim_in), t(n_slots, plan.sh_dim), t(n_slots, n_emb), t(n_emb, hidden),
                             t(hidden, plan.weight_numel), t(n_nodes, plan.mid_dim))
    want = K.conv_bwd_train_plain(plan, x, sh, emb, w1, w2, a0, a1, lay, g)
    _, (_, dW, _) = K._conv_bwd_terms(plan, x, sh, emb, w1, w2, a0, a1, lay, g)
    e32, w1_32 = emb.float()[:n], w1.float()
    a = e32 @ (w1_32 * a0)
    s = torch.sigmoid(a)
    prod = torch.from_numpy(card_product(dW.numpy(), w2.float().t().contiguous().numpy()))
    dh_pre = a1 * prod * (s * (1 + a * (1 - s)))
    demb = torch.nn.functional.pad(dh_pre @ (w1_32 * a0).t(), (0, 0, 0, n_slots - n)).to(torch.bfloat16)
    dw1 = K.dw_reduce_plain(emb, dh_pre.to(torch.bfloat16), a0, n)
    for label, got, ref in (("demb", demb, want[2]), ("dw1", dw1, want[3])):
        scale = float(ref.float().abs().max())
        err = float((got.float() - ref.float()).abs().max()) / scale
        print(f"{shape}: {label} {err:.3e} of max|out| (gate {TWIN_GATE:.0e})")
        assert got.dtype == ref.dtype and err <= TWIN_GATE


def _hidden(emb, w1, a0):
    """K1's hidden layer in float32 from bf16 emb and W1 (not rounded)."""
    return torch.nn.functional.silu(emb.float() @ (w1.float() * a0))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_k1_split_product_keeps_float32_gate(blocks, shape):
    """K1 (a): w = alpha1 h . W2 from the two bf16 terms of float32 h, W2
    bf16, against the float64 product, within 1e-4 of max|product|."""
    plan, (n_emb, hidden), (a0, a1) = _layer(blocks, shape)
    r = np.random.RandomState(26)
    t = lambda *s: torch.as_tensor(r.standard_normal(s), dtype=torch.bfloat16)  # noqa: E731
    h = _hidden(t(256, n_emb), t(n_emb, hidden), a0).numpy()
    w2 = t(hidden, plan.weight_numel).float().numpy()
    exact = a1 * (h.astype(np.float64) @ w2.astype(np.float64))
    scale = float(np.abs(exact).max())
    err = float(np.abs(a1 * card_product(h, w2) - exact).max()) / scale
    hi_only = float(np.abs(a1 * card_product(h, w2, terms=("hi",)) - exact).max()) / scale
    print(f"{shape}: hidden {hidden}, WN {plan.weight_numel}: hi + lo {err:.3e} of max|product|, hi alone "
          f"{hi_only:.3e} (gate {F32_GATE:.0e})")
    assert err <= F32_GATE


@pytest.mark.parametrize("shape", list(SHAPES))
def test_k1_twin_with_split_product_keeps_gate(blocks, shape):
    """K1 (b): conv_fwd_plain's bf16 arithmetic with w = bf16(alpha1 h . W2)
    taken as the card takes it (h float32 as hi + lo, W2 bf16, float32 sums
    per k16 step) in place of its float32 product: out within 8e-3 of
    max|out| of conv_fwd_plain's."""
    plan, (n_emb, hidden), (a0, a1) = _layer(blocks, shape)
    r = np.random.RandomState(27)
    lay = _stream("cpu", r)
    n_nodes, n_slots, n = lay.num_nodes, 256, lay.n_real
    t = lambda *s: torch.as_tensor(r.standard_normal(s), dtype=torch.bfloat16)  # noqa: E731
    x, sh, emb, w1, w2 = (t(n_nodes, plan.dim_in), t(n_slots, plan.sh_dim), t(n_slots, n_emb), t(n_emb, hidden),
                          t(hidden, plan.weight_numel))
    want = K.conv_fwd_plain(plan, x, sh, emb, w1, w2, a0, a1, lay)
    h = _hidden(emb[:n], w1, a0)
    w_card = _bf16(a1 * card_product(h.numpy(), w2.float().numpy()))
    w_plain = K._round_as(K.radial_weights(emb.float()[:n], w1.float(), w2.float(), a0, a1), torch.bfloat16)
    moved = float((torch.from_numpy(w_card) != w_plain).double().mean())
    dst, src = K._segment_rows(lay.dst_ptr), lay.edge_src[:n].long()
    msg = plan.tp(x.float()[src], sh.float()[:n], torch.from_numpy(w_card))
    got = K._bf16_nearest(torch.zeros(n_nodes, plan.mid_dim, dtype=torch.float64).index_add_(0, dst, msg.double()))
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max()) / scale
    print(f"{shape}: out {err:.3e} of max|out| (gate {TWIN_GATE:.0e}); w entries rounding to another bf16: "
          f"{moved:.3e}")
    assert got.dtype == want.dtype and err <= TWIN_GATE
