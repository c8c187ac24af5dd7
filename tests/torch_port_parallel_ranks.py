"""Ranks of the port's parallel tests.

``run_ranks`` runs a worker of this module on every rank of a gloo group
of spawned processes on the CPU, one torch thread each, meeting through a
``FileStore`` under the test's temporary directory (no TCP port, so
concurrent test workers cannot clash), with a process-group timeout and a
join deadline.  The workers live here (spawn pickles them by reference)
and import torch and the port only: the JAX references run in the test
process.  Each returns numpy arrays and floats.
"""

from __future__ import annotations

import datetime
import multiprocessing
import pickle
import time
import traceback
from pathlib import Path

import numpy as np

from nequip_tpu_torch.train.callbacks.base import Callback

R_MAX = 4.0


# ---------------------------------------------------------------------------
# spawned ranks
# ---------------------------------------------------------------------------
def _rank_main(fn, rank: int, world_size: int, workdir: str, device: str, backend: str, threads: int,
               pg_timeout_s: float, init: bool, args) -> None:
    import torch

    from nequip_tpu_torch.parallel.distributed import destroy_distributed, init_distributed

    torch.set_num_threads(threads)
    try:
        if init:
            init_distributed(backend=backend, device=device, init_method=f"file://{workdir}/store", rank=rank,
                             world_size=world_size, timeout=datetime.timedelta(seconds=pg_timeout_s))
        result = ("ok", fn(rank, *args))
    except BaseException:  # reported to the parent, which raises
        result = ("error", traceback.format_exc())
    finally:
        destroy_distributed()
    with open(Path(workdir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn, world_size: int, workdir, *args, device: str = "cpu", backend: str = "gloo", threads: int = 1,
              deadline_s: float = 240.0, pg_timeout_s: float = 90.0, init: bool = True) -> list:
    """``[fn(rank, *args) for rank in range(world_size)]``, each rank a
    spawned process in the default group (every rank on ``device`` over
    ``backend``; with ``init=False`` ``fn`` makes its own).  A rank's
    exception, or a rank still running at ``deadline_s`` (then killed),
    raises here."""
    work = Path(workdir) / f"pg_{fn.__name__}_{world_size}"
    work.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, str(work), device, backend, threads,
                                                  pg_timeout_s, init, args))
             for r in range(world_size)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if hung:
        raise TimeoutError(f"ranks {hung} of {world_size} still ran after {deadline_s} s")
    results = []
    for r, p in enumerate(procs):
        path = work / f"rank{r}.pkl"
        if not path.exists():
            raise RuntimeError(f"rank {r} exited with code {p.exitcode} and no result")
        with open(path, "rb") as f:
            status, value = pickle.load(f)  # written by the rank above
        if status != "ok":
            raise RuntimeError(f"rank {r} failed:\n{value}")
        results.append(value)
    return results


# ---------------------------------------------------------------------------
# the model and frames of tests/unit/parallel
# ---------------------------------------------------------------------------
GHOST_MODEL = dict(seed=0, model_dtype="float64", type_names=["Cu"], r_max=R_MAX, num_layers=2, l_max=1,
                   parity=False, num_features=4, radial_mlp_width=8, avg_num_neighbors=18.0,
                   per_type_energy_shifts={"Cu": -0.4})
DP_MODEL = dict(GHOST_MODEL, seed=1, avg_num_neighbors=12.0, per_type_energy_shifts={"Cu": -0.3})
SPATIAL_MODEL = dict(GHOST_MODEL, seed=11, avg_num_neighbors=12.0, per_type_energy_shifts={"Cu": -0.5})
OPT = {"_target_": "optax.adam", "learning_rate": 1e-2}
# an update that reads the loss: under data parallel and on the 2-D mesh the one merged over the ranks
POLYAK = {"_target_": "optax.polyak_sgd", "max_learning_rate": 100.0, "f_min": 0.0}  # the loss sets the step
# mode: (force_grad_mode, optimizer)
MODES = {"rr": ("rr", OPT), "fr": ("fr", OPT), "polyak": ("rr", POLYAK)}


def _model(kw: dict, params: dict, tp_impl: str):
    from nequip_tpu_torch.model import NequIPGNNModel, load_jax_params

    return load_jax_params(NequIPGNNModel(tp_impl=tp_impl, **kw), params)


def tensors_np(model) -> dict:
    return {k: t.detach().cpu().numpy().copy() for k, t in model.jax_named_tensors()}


METRIC_KEYS = ("train_loss_epoch/", "val0_epoch/")


def close_params(got: dict, want: dict, err: str = "") -> None:
    """Every tensor of ``got`` within 1e-10 of its max of ``want``'s."""
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=0, atol=1e-10 * max(np.abs(want[k]).max(), 1e-300),
                                   err_msg=f"{err} {k}")


class JaxStepRecorder:
    """A JAX trainer callback keeping each step's loss and parameters."""

    def __init__(self):
        self.steps = []

    def on_train_batch_end(self, trainer, module, logs, step):
        import jax

        from nequip_tpu_torch.model import flatten_tree

        self.steps.append({"loss": logs["train_loss_step/weighted_sum"],
                           "params": flatten_tree(jax.tree.map(np.asarray, trainer.state.params))})

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **kw: None
        raise AttributeError(name)

    def state_dict(self):
        return {}


class _StepRecorder(Callback):
    """A trainer callback keeping each step's loss and updated parameters."""

    def __init__(self):
        self.steps = []

    def on_train_batch_end(self, trainer, module, logs, step) -> None:
        self.steps.append({"loss": logs["train_loss_step/weighted_sum"], "params": tensors_np(module.model)})


# ---------------------------------------------------------------------------
# sharded-graph serving and training (tests/test_torch_port_parallel_ghost.py)
# ---------------------------------------------------------------------------
def sharded_checks(rank: int, frame: dict, params: dict, e_ref: float, f_ref) -> dict:
    """Sharded ``evaluate`` under "torch" and "fused", and ``loss_and_grad``
    in rr, fr and fr over edge slices under "fused", over the ranks."""
    import torch

    from nequip_tpu_torch.nn.interaction_block import InteractionBlock
    from nequip_tpu_torch.ops.kernels.tp_scatter import KERNELS, reset_launch_counts
    from nequip_tpu_torch.parallel import ShardedGraphEvaluator, disable_MeshGhostExchange
    from nequip_tpu_torch.parallel.ghost import MeshGhostExchange

    out = {}
    for impl in ("torch", "fused"):
        model = _model(GHOST_MODEL, params, impl)
        ev = ShardedGraphEvaluator(model, device="cpu")
        reset_launch_counts()
        out[f"evaluate_{impl}"] = ev.evaluate(frame)
        out[f"launches_{impl}"] = {k: fn.launches for k, fn in KERNELS.items()}
        out["exchanges"] = [type(m.ghost_exchange).__name__ for m in model.modules()
                            if isinstance(m, InteractionBlock)]
        disable_MeshGhostExchange(model)
        assert not any(isinstance(m, MeshGhostExchange) for m in model.modules())
        out[f"evaluate_{impl}_after_disable"] = ev.evaluate(frame)  # the evaluator installs the exchange again
    for mode, chunks in (("rr", 0), ("fr", 0), ("fr2", 2)):  # fr2: fr over 2 edge slices of each slab
        model = _model(GHOST_MODEL, params, "fused")
        ev = ShardedGraphEvaluator(model, force_grad_mode=mode[:2], device="cpu", fr_edge_chunks=chunks)
        loss, grads = ev.loss_and_grad(frame, e_ref, f_ref, energy_coeff=1.0, force_coeff=0.7)
        out[f"loss_{mode}"] = loss
        out[f"grads_{mode}"] = {k: g.numpy() for k, g in grads.items()}
    out["caps"] = ev.caps
    out["threads"] = torch.get_num_threads()
    return out


# ---------------------------------------------------------------------------
# data parallel through Trainer(devices=2) (tests/test_torch_port_parallel_dp.py)
# ---------------------------------------------------------------------------
def lj_dataset(num_frames: int, seed: int, supercell=None):
    from nequip_tpu_torch.data.dataset import LJTestDataset
    from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper, NeighborListTransform

    kw = {} if supercell is None else {"supercell": supercell}
    return LJTestDataset(num_frames=num_frames, seed=seed, transforms=[
        ChemicalSpeciesToAtomTypeMapper(["Cu"]), NeighborListTransform(R_MAX)], **kw)


def dp_fit(rank: int, params: dict, n_frames: int, mode: str, ckpt_root: str) -> dict:
    """One epoch of ``Trainer(devices=2)`` with batch 1 over ``n_frames``
    frames, no shuffle; rank 0 alone writes under ``ckpt_root``."""
    from nequip_tpu_torch.data import NequIPDataModule
    from nequip_tpu_torch.train import EnergyForceLoss, EnergyForceMetrics, NequIPTrainModule, Trainer

    ds = lj_dataset(n_frames, seed=7)
    dm = NequIPDataModule(seed=0, train_dataset=ds, val_dataset=ds, device="cpu",
                          train_dataloader={"batch_size": 1, "shuffle": False},
                          val_dataloader={"batch_size": 1})
    force_grad_mode, optimizer = MODES[mode]
    module = NequIPTrainModule(_model(DP_MODEL, params, "fused"), loss=EnergyForceLoss(per_atom_energy=True),
                               val_metrics=EnergyForceMetrics(), optimizer=optimizer, force_grad_mode=force_grad_mode,
                               device="cpu")
    ckpt = Path(ckpt_root) / f"rank{rank}"
    steps = _StepRecorder()
    trainer = Trainer(max_epochs=1, devices=2, ckpt_dir=str(ckpt), callbacks=[steps])
    trainer.fit(module, dm)
    return {"steps": steps.steps, "metrics": trainer.metrics_rows[-1], "params": tensors_np(module.model),
            "files": sorted(p.name for p in ckpt.glob("*")) if ckpt.exists() else []}


def config_fit(rank: int, params: dict, n_frames: int, ckpt_root: str, batch_size: int = 1,
               devices: int = 2) -> dict:
    """``dp_fit`` of ``ConFIGTrainModule`` (one process at batch 2 with
    ``devices=1``: the reference)."""
    from nequip_tpu_torch.data import NequIPDataModule
    from nequip_tpu_torch.train import ConFIGTrainModule, EnergyForceLoss, Trainer

    dm = NequIPDataModule(seed=0, train_dataset=lj_dataset(n_frames, seed=7), device="cpu",
                          train_dataloader={"batch_size": batch_size, "shuffle": False})
    module = ConFIGTrainModule(_model(DP_MODEL, params, "fused"), loss=EnergyForceLoss(per_atom_energy=True),
                               optimizer=OPT, device="cpu")
    steps = _StepRecorder()
    Trainer(max_epochs=1, devices=devices, ckpt_dir=str(Path(ckpt_root) / f"rank{rank}"), callbacks=[steps],
            save_last=False, save_best=False).fit(module, dm)
    return {"steps": steps.steps, "params": tensors_np(module.model)}


CONFIGS = str(Path(__file__).resolve().parents[1] / "nequip_tpu_torch" / "configs")


def cli_args(ckpt_dir: str, *extra: str) -> list:
    return ["-cn", "minimal_lj", "-cp", CONFIGS, "--device", "cpu", f"++trainer.ckpt_dir={ckpt_dir}", *extra]


def dp_cli(ckpt_dir: str) -> None:
    """The training CLI with ``trainer.devices=2``: one epoch, then resumed
    from ``last.ckpt`` for a second (both ranks share ``ckpt_dir``)."""
    from nequip_tpu_torch.scripts.train import main

    main(cli_args(ckpt_dir, "++trainer.devices=2", "++trainer.max_epochs=1"))
    main(cli_args(ckpt_dir, "++trainer.devices=2", "++trainer.max_epochs=2", f"++ckpt_path={ckpt_dir}/last.ckpt"))


def dp_checks(rank: int, params: dict, n_frames: int, ckpt_root: str) -> dict:
    """``dp_fit`` in rr and in fr, ``config_fit``, ``dp_cli``, and
    ``Trainer(devices=3)`` under a group of two, which raises by name."""
    from nequip_tpu_torch.train import Trainer

    out = {mode: dp_fit(rank, params, n_frames, mode, str(Path(ckpt_root) / mode)) for mode in MODES}
    out["config"] = config_fit(rank, params, n_frames, str(Path(ckpt_root) / "config"))
    out["cli_dir"] = str(Path(ckpt_root) / "cli")
    dp_cli(out["cli_dir"])
    try:
        Trainer(devices=3)._setup_data_parallel(None)
        out["devices_3"] = None
    except ValueError as e:
        out["devices_3"] = str(e)
    return out


# ---------------------------------------------------------------------------
# the 2-D mesh (tests/test_torch_port_parallel_spatial.py)
# ---------------------------------------------------------------------------
def spatial_fit(rank: int, params: dict, mode: str, ckpt_root: str, fr_edge_chunks: int = 0) -> dict:
    """One epoch of ``SpatialTrainModule`` on a (2, 2) mesh through the
    Trainer (val on the same frames), then the final parameters."""
    from nequip_tpu_torch.parallel import SpatialFrameDataModule, SpatialTrainModule, make_2d_mesh
    from nequip_tpu_torch.train import EnergyForceLoss, EnergyForceMetrics, Trainer

    ds = lj_dataset(4, seed=3, supercell=(4, 2, 2))
    mesh = make_2d_mesh(2, 2)
    force_grad_mode, optimizer = MODES[mode]
    module = SpatialTrainModule(_model(SPATIAL_MODEL, params, "fused"), loss=EnergyForceLoss(per_atom_energy=True),
                                val_metrics=EnergyForceMetrics(), optimizer=optimizer, force_grad_mode=force_grad_mode,
                                mesh=mesh,
                                fr_edge_chunks=fr_edge_chunks, device="cpu")
    steps = _StepRecorder()
    trainer = Trainer(max_epochs=1, save_last=False, save_best=False, callbacks=[steps],
                      ckpt_dir=str(Path(ckpt_root) / f"rank{rank}"))
    dm = SpatialFrameDataModule(ds, mesh, R_MAX, val_dataset=ds, shuffle=False, device="cpu")
    trainer.fit(module, dm)
    return {"steps": steps.steps, "metrics": trainer.metrics_rows[-1], "coords": dict(mesh.coords)}


def spatial_checks(rank: int, params: dict, ckpt_root: str) -> dict:
    out = {label: spatial_fit(rank, params, mode, str(Path(ckpt_root) / label), chunks)  # fr2: over 2 edge slices
           for label, mode, chunks in (("rr", "rr", 0), ("fr", "fr", 0), ("fr2", "fr", 2), ("polyak", "polyak", 0))}
    out["coords"] = out["rr"]["coords"]
    return out


# ---------------------------------------------------------------------------
# on one card over gloo (tests/test_torch_port_parallel_cuda.py)
# ---------------------------------------------------------------------------
def _lj_frame() -> dict:
    from nequip_tpu_torch.data.dataset import LJTestDataset

    lj = LJTestDataset(supercell=(4, 2, 2), num_frames=1, seed=12).frames[0]
    return {"pos": np.asarray(lj["pos"], dtype=np.float64), "cell": np.asarray(lj["cell"]).reshape(3, 3),
            "pbc": np.array([True] * 3), "atom_types": np.zeros(len(lj["pos"]), dtype=np.int64)}


def cuda_sharded(rank: int) -> dict:
    """Sharded ``evaluate`` (frozen weights: the registered ops) and rr
    ``loss_and_grad`` (the autograd Functions) of the float64 model on the
    card, and the same on one device, with each route's launches."""
    import torch

    from nequip_tpu_torch.data import batched_from_list, compute_neighborlist_, from_dict, pad_batch, to_tensors
    from nequip_tpu_torch.model import NequIPGNNModel
    from nequip_tpu_torch.ops.kernels.tp_scatter import KERNELS, reset_launch_counts
    from nequip_tpu_torch.parallel import ShardedGraphEvaluator, disable_MeshGhostExchange
    from nequip_tpu_torch.train.training_module import frozen_weights

    dev = torch.device("cuda:0")
    frame = _lj_frame()
    n = len(frame["pos"])
    f_ref = np.random.RandomState(5).standard_normal((n, 3))
    model = NequIPGNNModel(tp_impl="fused", **GHOST_MODEL).to(dev)
    out = {}
    reset_launch_counts()
    out["evaluate"] = ShardedGraphEvaluator(model, device=dev).evaluate(frame)
    out["evaluate_launches"] = {k: fn.launches for k, fn in KERNELS.items() if fn.launches}
    reset_launch_counts()
    loss, grads = ShardedGraphEvaluator(model, device=dev).loss_and_grad(frame, -20.0, f_ref, force_coeff=0.7)
    out["loss"], out["grads"] = loss, {k: g.cpu().numpy() for k, g in grads.items()}
    out["loss_launches"] = {k: fn.launches for k, fn in KERNELS.items() if fn.launches}

    disable_MeshGhostExchange(model)
    batch = to_tensors(pad_batch(batched_from_list([compute_neighborlist_(from_dict(dict(frame)), R_MAX)]),
                                 128, 4096, 2), dev)
    with frozen_weights(model):
        ref = model(batch)
    out["ref_energy"], out["ref_forces"] = float(ref["total_energy"][0, 0]), ref["forces"][:n].cpu().numpy()
    params = [(k, p) for k, p in model.jax_named_tensors() if isinstance(p, torch.nn.Parameter) and p.requires_grad]
    o = model(batch)
    de = (o["total_energy"][0, 0] - (-20.0)) / n
    fe = o["forces"][:n] - torch.as_tensor(f_ref, device=dev)
    ref_loss = de**2 + 0.7 * (fe * fe).sum() / (3.0 * n)
    ref_grads = torch.autograd.grad(ref_loss, [p for _, p in params])
    out["ref_loss"] = float(ref_loss)
    out["ref_grads"] = {k: g.cpu().numpy() for (k, _), g in zip(params, ref_grads)}
    return out


def nccl_refusal(rank: int, workdir: str) -> str:
    """``init_distributed`` with NCCL (the default on CUDA) and both ranks on
    ``cuda:0``: the error each rank raises."""
    import datetime

    from nequip_tpu_torch.parallel import init_distributed

    try:
        init_distributed(device="cuda:0", init_method=f"file://{workdir}/nccl_store", rank=rank, world_size=2,
                         timeout=datetime.timedelta(seconds=60))
    except RuntimeError as e:
        return str(e)
    return ""
