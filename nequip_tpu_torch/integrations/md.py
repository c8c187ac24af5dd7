"""Molecular dynamics: velocity Verlet and Nose-Hoover NVT with a Verlet skin.

Port of ``nequip_tpu/integrations/md.py``.  Positions, velocities, forces
and the thermostat variable stay on the device; the neighbour list is
rebuilt only when an atom has moved more than half the skin since the last
build, and the edge stream is put into kernel order once per build, not
once per force call.  Two neighbour-list backends, as in the JAX package:

* ``nl_backend="host"``: ``data/neighborlist.py`` (the C++ cell list by
  default) on the host, then padding, transfer and ``relayout_edge_stream``;
* ``nl_backend="device"``: the device cell list (``ops/device_nl.py``, a
  CUDA kernel) writes the edge stream in kernel order straight into the
  padded batch's tensors, and ``fill_edge_layout_`` refills the layout on
  the device: no position or edge crosses the host link.  Needs
  ``integration="block"``, a fully periodic box at least ``3 * (r_max +
  skin)`` thick, and ``tp_impl`` "fused" or "torch" (the force call then
  runs the registered ops, which read the real-edge count on the card).

Two ways to integrate, as in the JAX package:

* ``integration="host"``: each step runs the integrator's two halves on the
  device around one force call and reads back one scalar, the largest
  squared displacement since the last build;
* ``integration="block"``: ``steps_per_block`` steps at a time, then the
  skin check (one scalar read).  On a CUDA device a block is one CUDA graph
  (``torch.cuda.CUDAGraph``) over the driver's static position, velocity,
  force and thermostat buffers, captured after a one-step warm-up on a side
  stream.  A graph reads the padded batch and the edge layout through the
  addresses it was captured with, so a rebuild that keeps the capacities
  refills those tensors in place (the new edges in kernel order, the
  layout's CSR arrays, the source permutation in a buffer of the edge
  capacity) and the next replay runs on the new layout; a rebuild that
  grows a capacity makes new tensors and drops the graph, and the next
  block captures anew.  The captured kernel calls depend on no host integer
  that a refill changes: K1's carry rows are sized by the edge slots, K2
  zero-fills its whole per-edge ``dx``, and the kernels read the real-edge
  count from ``dst_ptr`` on the card.  On the CPU the same block runs
  eagerly.

With ``nl_backend="device"`` the JAX driver's order holds (its in-graph
rebuild block): after each block, if the largest displacement since the
last build exceeds half the skin, the list is rebuilt from the block's
final positions and the forces are refreshed.  The rebuild (list and
layout) and the force refresh are two more CUDA graphs over the same
static buffers, captured with the block graph and replayed after a block
whose one read-back (the displacement with the overflow flag, one
two-element copy) asks for it: the block graph stays free of a branch, and
the rebuild graph can be timed alone with CUDA events.  The JAX driver
repads its stream to ``n * k_max`` slots because its stream keeps masked
slots in place; this stream is compacted, so the driver keeps the edge
capacity of the first host build (with ``edge_headroom``), and the
captured force call has the shapes of the host path.  ``k_max`` and
``cell_cap`` are sized from that build as in JAX.  A bucket, an atom or
the stream that outgrows its capacity sets the overflow flag, which the
next read-back (and the end of ``run()``) turns into an error: the
capacities of a captured graph cannot grow, so the driver must be rebuilt
(or the host list used).

Units: metal-style (eV, Angstrom, amu, fs) with ASE's constants.
"""

from __future__ import annotations

import gc
import logging
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data import _keys, batched_from_list, compute_neighborlist_, from_dict, pad_batch, round_up, to_tensors
from ..ops.device_nl import cell_grid, device_nl, size_capacities, suggest_grid_dims
from ..ops.kernels.tp_scatter import LAYOUT_KEY, EdgeLayout, fill_edge_layout_, relayout_edge_stream
from ..utils.device import resolve_device

log = logging.getLogger("nequip_tpu_torch")

# ASE-compatible unit constants (eV, A, amu base units)
FS = 0.09822694750253231  # 1 fs in sqrt(amu A^2 / eV)
KB = 8.617330337217213e-05  # eV / K
OVERFLOW_MESSAGE = ("device neighborlist capacity overflow — density rose beyond the initial headroom; "
                    "rebuild the MDDriver (or use nl_backend='host')")


def _host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy (on the CPU, ``numpy()`` would share the state's memory)."""
    return t.cpu().numpy().copy()


def maxwell_boltzmann_velocities(masses, temperature_K: float, seed: int = 0, zero_momentum: bool = True) -> np.ndarray:
    """Velocities drawn from a Maxwell-Boltzmann distribution (ASE units:
    ``0.5 * m * v**2`` is in eV), from ``numpy.random.RandomState(seed)``
    exactly as the JAX package draws them.  Removing the net momentum
    lowers the temperature by ~1/N."""
    masses = np.asarray(masses, dtype=np.float64).reshape(-1)
    r = np.random.RandomState(seed)
    sigma = np.sqrt(KB * float(temperature_K) / masses)
    v = r.standard_normal((masses.shape[0], 3)) * sigma[:, None]
    if zero_momentum:
        v -= (masses[:, None] * v).sum(axis=0) / masses.sum()
    return v


class VelocityVerlet:
    """NVE integrator; the state is ``(pos, vel, forces, aux)`` (``aux``
    unused, a zero scalar)."""

    def __init__(self, dt_fs: float):
        self.dt = dt_fs * FS

    def make_step(self, force_fn: Callable, masses: torch.Tensor) -> Callable:
        dt = self.dt

        def step(state):
            pos, vel, forces, aux = state
            acc = forces / masses[:, None]
            vel_half = vel + 0.5 * dt * acc
            pos_new = pos + dt * vel_half
            forces_new = force_fn(pos_new)
            vel_new = vel_half + 0.5 * dt * forces_new / masses[:, None]
            return (pos_new, vel_new, forces_new, aux)

        return step

    def make_half_steps(self, masses: torch.Tensor):
        """``make_step`` split around the force call: ``half_a(state) ->
        (pos_new, carry)``, ``half_b(pos_new, carry, forces_new) -> state``."""
        dt = self.dt

        def half_a(state):
            pos, vel, forces, aux = state
            vel_half = vel + 0.5 * dt * forces / masses[:, None]
            return pos + dt * vel_half, (vel_half, aux)

        def half_b(pos_new, carry, forces_new):
            vel_half, aux = carry
            vel_new = vel_half + 0.5 * dt * forces_new / masses[:, None]
            return (pos_new, vel_new, forces_new, aux)

        return half_a, half_b

    def init_aux(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float64)


class NoseHoover:
    """Single-chain Nose-Hoover NVT thermostat (the half-step scheme with
    coupling ``nvt_q``); ``aux`` is the bath variable zeta."""

    def __init__(self, dt_fs: float, temperature_K: float, nvt_q: float = 334.0, n_dof: Optional[int] = None):
        self.dt = dt_fs * FS
        self.temperature = float(temperature_K)
        self.nvt_q = float(nvt_q)
        self.n_dof = n_dof

    def make_step(self, force_fn: Callable, masses: torch.Tensor) -> Callable:
        half_a, half_b = self.make_half_steps(masses)

        def step(state):
            pos_new, carry = half_a(state)
            return half_b(pos_new, carry, force_fn(pos_new))

        return step

    def make_half_steps(self, masses: torch.Tensor):
        """``make_step`` split around the force call (see
        ``VelocityVerlet.make_half_steps``).  ``half_a``: friction-modified
        half kick with the old zeta, drift, and two half-step bath updates
        from the old and the half-step kinetic energies (both before the
        force call); ``half_b``: the second half kick with the new zeta."""
        dt, q = self.dt, self.nvt_q
        n_dof = self.n_dof if self.n_dof is not None else 3 * masses.shape[0]
        kT = KB * self.temperature
        c = 0.5 * (n_dof + 1) * kT

        def half_a(state):
            pos, vel, forces, zeta = state
            acc_mod = forces / masses[:, None] - zeta * vel
            vel_half = vel + 0.5 * dt * acc_mod
            pos_new = pos + dt * vel_half
            ke_old = 0.5 * torch.sum(masses[:, None] * vel**2)
            zeta_half = zeta + 0.5 * dt / q * (ke_old - c)
            ke_half = 0.5 * torch.sum(masses[:, None] * vel_half**2)
            zeta_new = zeta_half + 0.5 * dt / q * (ke_half - c)
            return pos_new, (vel_half, zeta_new)

        def half_b(pos_new, carry, forces_new):
            vel_half, zeta_new = carry
            acc_new = forces_new / masses[:, None]
            vel_new = (vel_half + 0.5 * dt * acc_new) / (1.0 + 0.5 * dt * zeta_new)
            return (pos_new, vel_new, forces_new, zeta_new)

        return half_a, half_b

    def init_aux(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float64)


class MDDriver:
    """Skin-list MD loop over a port ``GraphModel``.

    ``frame`` holds ``pos``, ``atom_types`` and, for a periodic system,
    ``cell`` and ``pbc``.  The model moves to ``device`` (the card unless
    the caller asks for the CPU; raises without one) with its weights
    frozen, so the force call runs the inference kernels.  The integrator
    state is kept in the padded batch's position dtype (float64, as
    ``to_tensors`` makes it); the model computes in its own dtype.

    Capacities follow the JAX driver: nodes rounded up to ``pad_multiple``,
    edges to ``2 * pad_multiple`` with ``edge_headroom`` on the first build;
    a rebuild that outgrows the edge capacity grows it with fresh headroom.

    ``rebuild_timings`` holds, per neighbour-list build, the host seconds of
    the neighbour list and of padding, transfer and re-layout (synchronised;
    with ``nl_backend="device"`` the first, sizing build), then, per device
    rebuild, ``device_nl_ms``, the rebuild's (list and layout, not the force
    refresh) time on the card (CUDA events, read at the end of ``run()``;
    host seconds on the CPU); ``rebuilds`` counts the skin rebuilds;
    ``captures`` counts the block programs made (``integration="block"``:
    CUDA graphs captured on the card, eager programs on the CPU),
    ``capture_s`` the graphs' capture seconds (with their warm-up), and
    ``replays`` the blocks run by ``run()`` (graph replays on the card).
    ``step_clock`` holds ``(step_count, host seconds)`` at the start of the
    last ``run()`` and after each read-back (each step in ``"host"``, each
    block in ``"block"``).
    """

    def __init__(
        self,
        model,
        frame: dict,
        integrator,
        masses: Optional[np.ndarray] = None,
        skin: float = 0.5,
        steps_per_block: int = 10,
        pad_multiple: int = 128,
        nl_backend: str = "host",
        integration: str = "block",
        edge_headroom: float = 1.1,
        device="cuda",
    ):
        if nl_backend not in ("host", "device"):
            raise ValueError(f"nl_backend must be 'host' or 'device', not {nl_backend!r}")
        if integration not in ("block", "host"):
            raise ValueError(f"integration must be 'block' or 'host', not {integration!r}")
        if integration == "host" and nl_backend == "device":
            raise ValueError("integration='host' pairs with nl_backend='host'")
        self.device = resolve_device(device)
        self.model = model.to(self.device).requires_grad_(False)
        self.integrator = integrator
        self.skin = float(skin)
        self.steps_per_block = int(steps_per_block)
        self.pad_multiple = int(pad_multiple)
        self.r_max = float(model.r_max)
        self.nl_backend = nl_backend
        self.integration = integration
        self.edge_headroom = float(edge_headroom)

        data = from_dict(dict(frame))
        if _keys.ATOM_TYPE_KEY not in data:
            raise ValueError("frame must carry atom_types")
        self._frame = data
        n = data[_keys.POSITIONS_KEY].shape[0]
        if masses is None:
            masses = np.ones(n)
        self._cap = None
        self._batch: Optional[dict] = None
        self._program: Optional[Callable[[], torch.Tensor]] = None  # advances _state one block -> disp2
        self.rebuild_timings: List[Dict[str, float]] = []
        self._build_neighborlist()
        self._dtype = self._batch[_keys.POSITIONS_KEY].dtype
        self.masses = torch.as_tensor(np.asarray(masses), dtype=self._dtype, device=self.device)
        # static state of the block programs: (pos, vel, forces, aux), advanced in place
        self._state = tuple(torch.zeros(shape, dtype=self._dtype, device=self.device)
                            for shape in ((n, 3), (n, 3), (n, 3), ()))
        self._rebuild_programs: Optional[Tuple[Callable[[], None], Callable[[], None]]] = None
        self._pending_timings: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self.rebuilds = 0
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self.step_count = 0
        self.step_clock: List[Tuple[int, float]] = []
        if nl_backend == "device":
            self._setup_device_nl()

    # ------------------------------------------------------------------
    def _build_neighborlist(self) -> None:
        t0 = time.perf_counter()
        data = compute_neighborlist_(dict(self._frame), self.r_max + self.skin)
        t1 = time.perf_counter()
        batch = batched_from_list([data])
        self._n = batch[_keys.POSITIONS_KEY].shape[0]
        e = batch[_keys.EDGE_INDEX_KEY].shape[1]
        cap_n = round_up(self._n, self.pad_multiple)
        edge_multiple = 2 * self.pad_multiple
        if self._cap is None:
            # headroom on the first build: thermal fluctuations of the edge
            # count at skin rebuilds then fit the same capacity
            cap_e = round_up(int(e * self.edge_headroom), edge_multiple)
        else:
            cap_e = round_up(e, edge_multiple)
        grown = self._cap is None or cap_n > self._cap[0] or cap_e > self._cap[1]
        if grown:
            if self._cap is not None:
                cap_e = round_up(int(e * self.edge_headroom), edge_multiple)  # grow with fresh headroom
                log.warning(f"MD edge capacity outgrown ({e} > {self._cap[1]}): re-padding to {cap_e}")
            self._cap = (cap_n, cap_e)
        batch = to_tensors(pad_batch(batch, self._cap[0], self._cap[1], 2), self.device)
        if getattr(self.model, "uses_fused_kernels", False):
            batch = relayout_edge_stream(batch)  # once per build; the model skips it when attached
        self._nl_pos = np.asarray(self._frame[_keys.POSITIONS_KEY])
        nl_pos = torch.as_tensor(self._nl_pos, dtype=batch[_keys.POSITIONS_KEY].dtype, device=self.device)
        if grown:
            self._adopt(batch, nl_pos)
        else:
            self._refill(batch, nl_pos)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.rebuild_timings.append({"neighbor_list_s": t1 - t0, "relayout_s": time.perf_counter() - t1})

    # ------------------------------------------------------------------
    # the device cell list (nl_backend="device")
    # ------------------------------------------------------------------
    def _setup_device_nl(self) -> None:
        """Size the device cell list from the first (host) build, as the JAX
        driver does, then rebuild the batch's edges with it."""
        routes = {m.route for m in self.model.modules() if hasattr(m, "route")}
        if "fused_tp" in routes:
            # K4's route (tp_impl "fused_tp", or "fused" with a radial MLP K1
            # does not take) has not been run in the device-list graphs
            raise ValueError("nl_backend='device' takes K1's route or the plain one: use tp_impl 'fused' or "
                             "'torch' (with 'fused', the depth-1 radial MLP)")
        if _keys.CELL_KEY not in self._frame:
            raise ValueError("nl_backend='device' needs a periodic box (a cell)")
        cell = np.asarray(self._frame[_keys.CELL_KEY], dtype=np.float64).reshape(3, 3)
        pbc = np.asarray(self._frame.get(_keys.PBC_KEY, np.ones(3, bool))).reshape(-1)
        if not pbc.all():
            raise ValueError("nl_backend='device' needs a fully periodic box")
        r_build = self.r_max + self.skin
        dims = suggest_grid_dims(cell, r_build)
        dst = self._batch[_keys.EDGE_INDEX_KEY][0][self._batch[_keys.EDGE_MASK_KEY]].cpu().numpy()
        self._nl_caps = size_capacities(self._frame[_keys.POSITIONS_KEY], cell, dims, dst)
        self._grid = cell_grid(cell, r_build, dims, self._dtype, self.device)
        self._overflow = torch.zeros(1, dtype=torch.int32, device=self.device)
        layout = self._batch.get(LAYOUT_KEY)
        if layout is not None:  # refilled in place from here on, over the whole permutation buffer
            self._batch[LAYOUT_KEY] = EdgeLayout(layout.edge_src, layout.dst_ptr, self._src_perm, layout.src_ptr, None)
        pos = torch.as_tensor(np.asarray(self._frame[_keys.POSITIONS_KEY]), dtype=self._dtype, device=self.device)
        self._timed(lambda: self._device_rebuild(pos))
        self._check_overflow()

    def _device_rebuild(self, pos: torch.Tensor) -> None:
        """The list from ``pos`` into the batch's edge tensors and layout, in
        place, with no read-back (a CUDA graph captures it)."""
        b = self._batch
        device_nl(pos, self._grid, *self._nl_caps, self._overflow, pad_index=self._cap[0] - 1,
                  out=(b[_keys.EDGE_INDEX_KEY], b[_keys.EDGE_CELL_SHIFT_KEY], b[_keys.EDGE_MASK_KEY]))
        if LAYOUT_KEY in b:
            b[LAYOUT_KEY] = fill_edge_layout_(b[LAYOUT_KEY], b[_keys.EDGE_INDEX_KEY], b[_keys.EDGE_MASK_KEY])
        self._nl_pos_dev.copy_(pos)

    def _timed(self, rebuild: Callable[[], None]) -> None:
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            rebuild()
            self.rebuild_timings.append({"device_nl_ms": 1e3 * (time.perf_counter() - t0)})
            return
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rebuild()
        end.record()
        self._pending_timings.append((start, end))

    def _read_timings(self) -> None:
        """Rebuild times on the card, once the stream has passed them."""
        for start, end in self._pending_timings:
            end.synchronize()
            self.rebuild_timings.append({"device_nl_ms": start.elapsed_time(end)})
        self._pending_timings = []

    def _check_overflow(self) -> None:
        if int(self._overflow.item()):
            raise RuntimeError(OVERFLOW_MESSAGE)

    def _rebuild_and_refresh(self) -> None:
        """Rebuild from the block's final positions, then refresh the forces
        (on the card: two graph replays, captured with the block graph)."""
        rebuild, refresh = self._rebuild_programs
        self._timed(rebuild)
        refresh()
        self.rebuilds += 1

    def _refresh_forces(self) -> None:
        self._state[2].copy_(self.forces(self._state[0]))

    # ------------------------------------------------------------------
    def _adopt(self, batch: dict, nl_pos: torch.Tensor) -> None:
        """New batch tensors (first build, or a capacity changed): the block
        program made on the old ones is dropped."""
        self._program = None
        layout = batch.get(LAYOUT_KEY)
        if layout is not None:
            self._src_perm = torch.empty(batch[_keys.EDGE_INDEX_KEY].shape[1], dtype=torch.int32, device=self.device)
            batch[LAYOUT_KEY] = self._layout_over(layout, layout)
        self._batch = batch
        self._nl_pos_dev = nl_pos
        self._pos_pad = torch.zeros(self._cap[0] - self._n, 3, dtype=nl_pos.dtype, device=self.device)

    def _refill(self, batch: dict, nl_pos: torch.Tensor) -> None:
        """Same shapes: copy the new build into the tensors the block program
        reads, and put a layout with the new real-edge count over them."""
        for k, v in batch.items():
            if isinstance(v, torch.Tensor):
                self._batch[k].copy_(v)
        layout = batch.get(LAYOUT_KEY)
        if layout is not None:
            static = self._batch[LAYOUT_KEY]
            for name in ("edge_src", "dst_ptr", "src_ptr"):
                getattr(static, name).copy_(getattr(layout, name))
            self._batch[LAYOUT_KEY] = self._layout_over(static, layout)
        self._nl_pos_dev.copy_(nl_pos)

    def _layout_over(self, static: EdgeLayout, layout: EdgeLayout) -> EdgeLayout:
        """``layout`` over ``static``'s CSR tensors, its source permutation
        copied into the prefix of the edge-capacity buffer."""
        self._src_perm[: layout.n_real].copy_(layout.src_perm)
        return EdgeLayout(static.edge_src, static.dst_ptr, self._src_perm[: layout.n_real], static.src_ptr,
                          layout.n_real)

    def _model_out(self, pos: torch.Tensor) -> dict:
        d = dict(self._batch)
        d[_keys.POSITIONS_KEY] = torch.cat([pos, self._pos_pad])
        return self.model(d)

    def forces(self, pos: torch.Tensor) -> torch.Tensor:
        """Forces on the real atoms at positions ``pos [n, 3]``, with the
        current neighbour list."""
        return self._model_out(pos)[_keys.FORCE_KEY][: self._n].to(pos.dtype)

    def _potential_energy(self, pos: torch.Tensor) -> float:
        return float(self._model_out(pos)[_keys.TOTAL_ENERGY_KEY].reshape(-1)[0])

    def _disp2(self, pos: torch.Tensor) -> torch.Tensor:
        """Largest squared displacement since the last build (0-d, on the device)."""
        return torch.amax(torch.sum((pos - self._nl_pos_dev) ** 2, dim=1))

    # ------------------------------------------------------------------
    def _advance_block(self, state) -> torch.Tensor:
        """``steps_per_block`` steps from ``state``, written back into it;
        returns the block's status: the largest squared displacement since
        the last build (and, with the device list, the overflow flag)."""
        step = self.integrator.make_step(self.forces, self.masses)
        new = state
        for _ in range(self.steps_per_block):
            new = step(new)
        for dst, src in zip(state, new):
            dst.copy_(src)
        disp2 = self._disp2(state[0])
        if self.nl_backend == "device":
            return torch.stack([disp2, self._overflow[0].to(disp2.dtype)])
        return disp2

    def _block_program(self) -> Callable[[], torch.Tensor]:
        """The program that advances ``_state`` one block over the current
        batch tensors (made anew after ``_adopt``)."""
        if self._program is None:
            on_card = self.device.type == "cuda"
            block = lambda: self._advance_block(self._state)  # noqa: E731
            self._program = self._capture(block) if on_card else block
            if self.nl_backend == "device":  # the rebuild's programs too, before any step is timed
                programs = (lambda: self._device_rebuild(self._state[0]), self._refresh_forces)
                self._rebuild_programs = tuple(self._capture(p, warm=False) for p in programs) if on_card else programs
            self.captures += 1
        return self._program

    def _capture(self, fn: Callable, warm: bool = True) -> Callable:
        """``fn`` as a CUDA graph over the driver's static buffers; ``warm``
        runs one integrator step on copies of the state first."""
        t0 = time.perf_counter()
        # a graph that only a dead reference cycle still holds must not be
        # destroyed by the collector during the capture, which forbids it
        gc.collect()
        if warm:
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                # one step on copies of the state: lazy set-up (library handles,
                # kernel attributes and tile sizes, device tables) stays out of the graph
                copies = tuple(t.clone() for t in self._state)
                self.integrator.make_step(self.forces, self.masses)(copies)
            current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
        torch.cuda.synchronize(self.device)
        self.capture_s += time.perf_counter() - t0

        def replay():  # holds the graph, not the driver: no cycle keeps it alive
            graph.replay()
            return out

        return replay

    # ------------------------------------------------------------------
    def _thermo_row(self, state) -> dict:
        pos, vel = state[0], state[1]
        # ASE units (amu, A, eV, time = sqrt(amu A^2/eV)): 0.5 m v^2 is eV
        ke = float(0.5 * np.sum(self.masses.cpu().numpy()[:, None] * vel.cpu().numpy() ** 2))
        pe = self._potential_energy(pos)
        temp = 2.0 * ke / (3 * self._n * KB)
        return {
            "step": self.step_count,
            "potential_energy": pe,
            "kinetic_energy": ke,
            "total_energy": pe + ke,
            "temperature_K": temp,
        }

    def _write_xyz_frame(self, fh, state, comment: str) -> None:
        pos = state[0].cpu().numpy()
        types = np.asarray(self._frame[_keys.ATOM_TYPE_KEY]).reshape(-1)
        names = getattr(self.model, "type_names", None) or [str(t) for t in range(int(types.max()) + 1)]
        fh.write(f"{self._n}\n{comment}\n")
        for t, (x, y, z) in zip(types, pos):
            fh.write(f"{names[int(t)]} {x:.8f} {y:.8f} {z:.8f}\n")

    def _record(self, thermo: list, traj_fh, state) -> None:
        row = self._thermo_row(state)
        thermo.append(row)
        log.info(
            f"MD step {row['step']}: PE={row['potential_energy']:.6f} "
            f"KE={row['kinetic_energy']:.6f} T={row['temperature_K']:.1f}K"
        )
        if traj_fh:
            self._write_xyz_frame(traj_fh, state, f"step={self.step_count}")

    def _rebuild(self, pos: torch.Tensor) -> None:
        self._frame[_keys.POSITIONS_KEY] = _host(pos)
        self._build_neighborlist()
        self.rebuilds += 1

    def _run_host(self, state, n_steps: int, log_every_blocks, traj_fh, thermo: list):
        half_a, half_b = self.integrator.make_half_steps(self.masses)
        half_skin2 = (0.5 * self.skin) ** 2
        for i in range(int(n_steps)):
            pos_new, carry = half_a(state)
            state = half_b(pos_new, carry, self.forces(pos_new))
            disp2 = self._disp2(state[0])
            self.step_count += 1
            moved = float(disp2) > half_skin2  # the step's one read-back
            self.step_clock.append((self.step_count, time.perf_counter()))
            if moved:
                self._rebuild(state[0])
                # fresh forces on the new edge set
                state = (state[0], state[1], self.forces(state[0])) + tuple(state[3:])
            if (i + 1) % self.steps_per_block == 0:
                n_blocks = (i + 1) // self.steps_per_block
                if log_every_blocks and n_blocks % log_every_blocks == 0:
                    self._record(thermo, traj_fh, state)
        return state

    def _run_blocks(self, state, n_steps: int, log_every_blocks, traj_fh, thermo: list):
        for dst, src in zip(self._state, state):
            dst.copy_(src)
        state = self._state
        steps_done = n_blocks = 0
        device_list = self.nl_backend == "device"
        while steps_done < n_steps:
            status = self._block_program()().tolist()  # the block's one read-back
            self.replays += 1
            steps_done += self.steps_per_block
            self.step_count += self.steps_per_block
            n_blocks += 1
            if device_list and status[1]:
                raise RuntimeError(OVERFLOW_MESSAGE)
            if log_every_blocks and n_blocks % log_every_blocks == 0:
                self._record(thermo, traj_fh, state)
            moved = math.sqrt(status[0] if device_list else status) > 0.5 * self.skin
            self.step_clock.append((self.step_count, time.perf_counter()))
            if moved and device_list:
                self._rebuild_and_refresh()
            elif moved:
                self._rebuild(state[0])
                state[2].copy_(self.forces(state[0]))
        if device_list:
            self._check_overflow()
            self._read_timings()
        return state

    @torch.no_grad()
    def run(
        self,
        n_steps: int,
        velocities: Optional[np.ndarray] = None,
        log_every_blocks: Optional[int] = None,
        traj_path: Optional[str] = None,
    ) -> dict:
        """Run MD from the frame's positions; returns final positions,
        velocities, forces, ``aux``, ``kinetic_energy`` and ``thermo``.

        ``log_every_blocks=k`` records a thermo row (PE/KE/total E/T) at the
        start and every k blocks; ``traj_path`` appends an XYZ frame at the
        same cadence.  ``integration="block"`` runs whole blocks (``n_steps``
        rounded up to a multiple of ``steps_per_block``).

        A later ``run()`` starts from the positions where this one ended
        (they are written back into the driver's frame; the neighbour list
        and its skin reference stay), with the velocities it is given, or
        zero, and a fresh thermostat variable.  (The JAX driver writes
        positions back only at a rebuild, so its second run restarts from
        the last build's positions.)
        """
        pos = torch.as_tensor(np.asarray(self._frame[_keys.POSITIONS_KEY]), dtype=self._dtype, device=self.device)
        vel = (torch.as_tensor(np.asarray(velocities), dtype=self._dtype, device=self.device)
               if velocities is not None else torch.zeros_like(pos))
        aux = self.integrator.init_aux().to(dtype=self._dtype, device=self.device)
        state = (pos, vel, self.forces(pos), aux)
        self.step_clock = [(self.step_count, time.perf_counter())]
        thermo: List[dict] = []
        traj_fh = open(traj_path, "a") if traj_path is not None else None
        try:
            if log_every_blocks:
                self._record(thermo, traj_fh, state)
            if self.integration == "host":
                state = self._run_host(state, n_steps, log_every_blocks, traj_fh, thermo)
            else:
                state = self._run_blocks(state, n_steps, log_every_blocks, traj_fh, thermo)
        finally:
            if traj_fh:
                traj_fh.close()
        pos, vel, forces, aux = (_host(t) for t in state)
        self._frame[_keys.POSITIONS_KEY] = pos
        return {
            "positions": pos,
            "velocities": vel,
            "forces": forces,
            "aux": aux,
            "kinetic_energy": float(0.5 * np.sum(self.masses.cpu().numpy()[:, None] * vel**2)),
            "thermo": thermo,
        }
