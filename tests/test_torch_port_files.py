"""The port's data files against the JAX package's: extxyz, NPZ, HDF5, the
extxyz path of ``ASEDataset``, LMDB, shards, the transforms and the named
data modules, on the CPU.

Mirrors ``tests/unit/data/test_{file_datasets,shard_dataset,named_datamodules}.py``
case by case, each case run through both packages on the same files made
from a numpy seed: the same arrays and dtypes (exact: the same host numpy
code), byte-identical extxyz and shard files, either package reading the
other's shards, the same split indices and frames, and the same errors.
No download is attempted: the named data modules find their files in
place, and the offline case replaces ``urllib.request.urlretrieve`` with a
function that raises.
"""

import multiprocessing
import os
import urllib.request
import warnings

import numpy as np
import pytest

from nequip_tpu.data import DataLoader as JLoader
from nequip_tpu.data import _keys
from nequip_tpu.data import datamodule as jdm
from nequip_tpu.data import transforms as jtr
from nequip_tpu.data import xyz as jxyz
from nequip_tpu.data.dataset import ASEDataset as JASEDataset
from nequip_tpu.data.dataset import HDF5Dataset as JHDF5Dataset
from nequip_tpu.data.dataset import LJTestDataset as JLJ
from nequip_tpu.data.dataset import LMDBDataset as JLMDBDataset
from nequip_tpu.data.dataset import NPZDataset as JNPZDataset
from nequip_tpu.data.dataset import ShardDataset as JShardDataset

from nequip_tpu_torch.data import DataLoader, to_tensors
from nequip_tpu_torch.data import datamodule as pdm
from nequip_tpu_torch.data import transforms as ptr
from nequip_tpu_torch.data import xyz as pxyz
from nequip_tpu_torch.data.dataset import ASEDataset, HDF5Dataset, LJTestDataset, LMDBDataset, NPZDataset, ShardDataset


def _assert_frames_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _assert_datasets_equal(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        _assert_frames_equal(got[i], want[i])


# --- extxyz --------------------------------------------------------------------
def _xyz_frames(seed=5, n=3):
    rng = np.random.RandomState(seed)
    return [
        {
            _keys.POSITIONS_KEY: rng.uniform(0, 4, (4, 3)),
            _keys.ATOMIC_NUMBERS_KEY: np.array([29, 29, 1, 8]),
            _keys.CELL_KEY: rng.uniform(3, 6, (3, 3)),
            _keys.PBC_KEY: np.array([True, True, False]),
            _keys.TOTAL_ENERGY_KEY: np.array([[-12.5 + i]]),
            _keys.FORCE_KEY: rng.standard_normal((4, 3)),
        }
        for i in range(n)
    ]


def test_write_extxyz_is_byte_identical(tmp_path):
    frames = _xyz_frames()
    frames.append({_keys.POSITIONS_KEY: np.random.RandomState(1).standard_normal((2, 3))})  # no labels, no cell
    pxyz.write_extxyz(str(tmp_path / "port.extxyz"), frames)
    jxyz.write_extxyz(str(tmp_path / "jax.extxyz"), frames)
    assert (tmp_path / "port.extxyz").read_bytes() == (tmp_path / "jax.extxyz").read_bytes()


EXTXYZ_TEXT = """3
Lattice="5.0 0.0 0.0 0.0 5.0 0.0 0.0 0.0 5.0" Properties=species:S:1:pos:R:3:Z:I:1:fixed:L:1:force:R:3:charge:R:1 energy=-3.25 stress="1 2 3 2 4 5 3 5 6" pbc="T T F" config_type=bulk n_iter=7 converged=T tags="1 2"
Cu 0.0 0.0 0.0 29 T 0.1 0.2 0.3 0.5
H 1.0 1.5 0.5 1 F -0.1 0.0 0.2 -0.25
O 2.0 0.5 1.5 8 T 0.0 -0.2 -0.5 -0.25

2
Properties=species:S:1:pos:R:3 TotEnergy=1.5 virial="1 0 0 0 1 0 0 0 1"
C 0.0 0.0 0.0
N 0.0 0.0 1.2
"""


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"key_mapping": {"TotEnergy": "total_energy"}}, {"include_keys": ["charge"]}, {"index": 1}],
    ids=["default", "key_mapping", "include_keys", "index"],
)
def test_read_extxyz_matches_jax(tmp_path, kwargs):
    path = tmp_path / "mixed.extxyz"
    path.write_text(EXTXYZ_TEXT)
    got, want = pxyz.read_extxyz(str(path), **kwargs), jxyz.read_extxyz(str(path), **kwargs)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert type(g[k]) is type(w[k]) and g[k] == w[k], k


def test_extxyz_roundtrip(tmp_path):
    """write_extxyz -> read_extxyz is lossless for the canonical fields."""
    frames = _xyz_frames()
    path = str(tmp_path / "rt.extxyz")
    pxyz.write_extxyz(path, frames)
    back = pxyz.read_extxyz(path)
    assert len(back) == 3
    for a, b in zip(frames, back):
        for k in (_keys.POSITIONS_KEY, _keys.CELL_KEY, _keys.FORCE_KEY, _keys.TOTAL_ENERGY_KEY):
            np.testing.assert_allclose(b[k], np.asarray(a[k]).reshape(b[k].shape), atol=1e-9, err_msg=k)
        np.testing.assert_array_equal(b[_keys.ATOMIC_NUMBERS_KEY], a[_keys.ATOMIC_NUMBERS_KEY])
        np.testing.assert_array_equal(b[_keys.PBC_KEY], a[_keys.PBC_KEY])


# --- NPZ, HDF5, ASE, LMDB -------------------------------------------------------
def _npz(path, seed=0):
    r = np.random.RandomState(seed)
    n_frames, n_atoms = 4, 5
    np.savez(path, R=r.standard_normal((n_frames, n_atoms, 3)) * 3, E=r.standard_normal(n_frames),
             F=r.standard_normal((n_frames, n_atoms, 3)), z=np.array([6, 1, 1, 8, 1]),
             cell=np.tile(np.eye(3) * 9.0, (n_frames, 1, 1)), extra=np.arange(3.0))


def test_npz_dataset_matches_jax(tmp_path):
    path = str(tmp_path / "data.npz")
    _npz(path)
    got, want = NPZDataset(path), JNPZDataset(path)
    _assert_datasets_equal(got, want)
    f = got[1]
    assert f[_keys.POSITIONS_KEY].shape == (5, 3) and f[_keys.TOTAL_ENERGY_KEY].shape == (1, 1)
    np.testing.assert_array_equal(f[_keys.ATOMIC_NUMBERS_KEY].reshape(-1), [6, 1, 1, 8, 1])
    mapped = {"extra": "bonus"}
    _assert_datasets_equal(NPZDataset(path, key_mapping=mapped), JNPZDataset(path, key_mapping=mapped))


@pytest.mark.parametrize("layout", ["grouped", "flat"])
def test_hdf5_dataset_matches_jax(tmp_path, layout):
    import h5py

    r = np.random.RandomState(1)
    path = str(tmp_path / "data.h5")
    with h5py.File(path, "w") as f:
        if layout == "grouped":
            for i in range(3):
                g = f.create_group(f"frame_{i}")
                g["pos"] = r.standard_normal((4, 3))
                g["atomic_numbers"] = np.array([29] * 4)
                g["energy"] = np.array(r.standard_normal())
                g["forces"] = r.standard_normal((4, 3)).astype(np.float32)
        else:
            f["R"] = r.standard_normal((3, 4, 3))
            f["z"] = np.tile(np.array([29, 1, 1, 8]), (3, 1))
            f["E"] = r.standard_normal(3)
    got, want = HDF5Dataset(path), JHDF5Dataset(path)
    _assert_datasets_equal(got, want)
    frame = got[2]
    assert frame[_keys.POSITIONS_KEY].shape == (4, 3) and frame[_keys.TOTAL_ENERGY_KEY].shape == (1, 1)


def test_ase_dataset_reads_extxyz_as_jax(tmp_path):
    path = tmp_path / "mixed.xyz"
    path.write_text(EXTXYZ_TEXT)
    kw = dict(key_mapping={"TotEnergy": "total_energy"}, include_keys=["charge", "virial"],
              transforms=[jtr.ChemicalSpeciesToAtomTypeMapper(["H", "C", "N", "O", "Cu"])])
    want = JASEDataset(str(path), **kw)
    got = ASEDataset(str(path), **dict(kw, transforms=[ptr.ChemicalSpeciesToAtomTypeMapper(["H", "C", "N", "O", "Cu"])]))
    _assert_datasets_equal(got, want)
    assert [got.get_frame(i).keys() for i in range(2)] == [want.get_frame(i).keys() for i in range(2)]


def test_ase_dataset_non_xyz_raises_as_jax(tmp_path):
    path = str(tmp_path / "traj.traj")
    with pytest.raises(ImportError) as want:
        JASEDataset(path)
    with pytest.raises(ImportError) as got:
        ASEDataset(path)
    assert str(got.value) == str(want.value)


def test_lmdb_dataset_raises_import_error(tmp_path):
    path = str(tmp_path / "data.lmdb")
    for cls in (JLMDBDataset, LMDBDataset):
        ds = cls(path)
        with pytest.raises(ImportError, match="lmdb"):
            len(ds)
        with pytest.raises(ImportError, match="lmdb"):
            cls.save_from_iterator(path, iter([]))


# --- shards ------------------------------------------------------------------------
def _frames(n=7, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        na = int(rng.randint(3, 9))
        out.append(
            {
                _keys.POSITIONS_KEY: rng.standard_normal((na, 3)),
                _keys.ATOMIC_NUMBERS_KEY: rng.randint(1, 10, na).astype(np.int64),
                _keys.TOTAL_ENERGY_KEY: np.asarray([[rng.standard_normal()]]),
                _keys.FORCE_KEY: rng.standard_normal((na, 3)).astype(np.float32),
                _keys.PBC_KEY: np.array([True, False, True]),
                "tag": np.array([i], dtype=np.int16),
                "small": rng.standard_normal(2).astype(np.float16),
                "plain_int": np.arange(na, dtype=np.int32),
            }
        )
    return out


META = {"cutoff": 4.5, "type_names": ["H", "C"], "counts": np.arange(5), "shape": (2, 3)}


def test_shard_files_are_byte_identical_and_cross_read(tmp_path):
    frames = _frames()
    paths = {"port": str(tmp_path / "port.nqs"), "jax": str(tmp_path / "jax.nqs")}
    ShardDataset.save_from_iterator(paths["port"], iter(frames), metadata=META)
    JShardDataset.save_from_iterator(paths["jax"], iter(frames), metadata=META)
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
    # each package reads the other's file
    for reader, path in ((ShardDataset, paths["jax"]), (JShardDataset, paths["port"])):
        ds = reader(path)
        assert len(ds) == len(frames)
        for i, ref in enumerate(frames):
            _assert_frames_equal(ds.get_frame(i), {k: np.asarray(v) for k, v in ref.items()})
        for key in ("num_atoms_per_entry", "cutoff", "type_names", "counts", "shape", "missing"):
            a, b = ds.get_metadata(key), JShardDataset(paths["jax"]).get_metadata(key)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, key


def test_shard_roundtrip(tmp_path):
    frames = _frames()
    path = str(tmp_path / "data.nqs")
    ShardDataset.save_from_iterator(path, iter(frames))
    ds = ShardDataset(path)
    assert len(ds) == len(frames)
    for i, ref in enumerate(frames):
        _assert_frames_equal(ds.get_frame(i), {k: np.asarray(v) for k, v in ref.items()})
    with pytest.raises(IndexError):
        ds.get_frame(len(frames))
    _assert_datasets_equal(ds, JShardDataset(path))


def test_shard_metadata(tmp_path):
    frames = _frames(5)
    path = str(tmp_path / "data.nqs")
    ShardDataset.save_from_iterator(path, iter(frames), metadata={"cutoff": 4.5, "type_names": ["H", "C"],
                                                                  "counts": np.arange(5)})
    ds = ShardDataset(path)
    np.testing.assert_array_equal(ds.get_metadata("num_atoms_per_entry"), [len(f[_keys.POSITIONS_KEY]) for f in frames])
    assert float(ds.get_metadata("cutoff")) == 4.5
    assert ds.get_metadata("type_names") == ["H", "C"]
    np.testing.assert_array_equal(ds.get_metadata("counts"), np.arange(5))
    assert ds.get_metadata("missing") is None


def test_shard_reads_are_read_only_views_copied_into_tensors(tmp_path):
    frames = _frames(3)
    path = str(tmp_path / "data.nqs")
    ShardDataset.save_from_iterator(path, iter(frames))
    raw = ShardDataset(path).get_frame(0)
    pos = raw[_keys.POSITIONS_KEY]
    assert not pos.flags.owndata and not pos.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # torch warns on a non-writable array it would share
        t = to_tensors({k: v for k, v in raw.items() if k != "small"}, "cpu")
    t[_keys.POSITIONS_KEY].add_(1.0)  # the tensor owns its memory
    np.testing.assert_array_equal(ShardDataset(path).get_frame(0)[_keys.POSITIONS_KEY], frames[0][_keys.POSITIONS_KEY])


def test_shard_in_loader_pipeline_matches_jax(tmp_path):
    src = LJTestDataset(num_frames=6, supercell=(1, 1, 2), seed=1)
    path = str(tmp_path / "lj.nqs")
    ShardDataset.save_from_iterator(path, (src.get_frame(i) for i in range(len(src))))
    got = list(DataLoader(ShardDataset(path, transforms=[ptr.NeighborListTransform(r_max=3.0, backend="kdtree")]),
                          batch_size=3, shuffle=True, seed=4, device=None))
    want = list(JLoader(JShardDataset(path, transforms=[jtr.NeighborListTransform(r_max=3.0)]), batch_size=3,
                        shuffle=True, seed=4, device=False))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        _assert_frames_equal(a, b)
    first = list(DataLoader(ShardDataset(path, transforms=[ptr.NeighborListTransform(r_max=3.0)]), batch_size=3,
                            device="cpu"))[0]
    f0 = src.get_frame(0)
    n0 = len(f0[_keys.POSITIONS_KEY])
    np.testing.assert_array_equal(first[_keys.POSITIONS_KEY][:n0].numpy(), f0[_keys.POSITIONS_KEY])
    assert _keys.EDGE_INDEX_KEY in first and first[_keys.POSITIONS_KEY].dim() == 2


def _read_entry(path, idx, q):
    q.put(np.asarray(ShardDataset(path).get_frame(idx)[_keys.POSITIONS_KEY]).sum())


def test_shard_fork_safety(tmp_path):
    """Open in the parent, read in forked workers: the mmap is opened again
    in each process."""
    frames = _frames(4)
    path = str(tmp_path / "data.nqs")
    ShardDataset.save_from_iterator(path, iter(frames))
    ds = ShardDataset(path)
    ds.get_frame(0)
    ctx = multiprocessing.get_context("fork")
    q = ctx.Queue()
    procs = [ctx.Process(target=_read_entry, args=(path, i, q)) for i in range(4)]
    for p in procs:
        p.start()
    vals = sorted(q.get(timeout=30) for _ in procs)
    for p in procs:
        p.join()
    np.testing.assert_allclose(vals, sorted(f[_keys.POSITIONS_KEY].sum() for f in frames))


# --- transforms ------------------------------------------------------------------
def _transform_frames():
    lj = JLJ(num_frames=2, seed=3, supercell=(1, 1, 2))
    molecule = {_keys.POSITIONS_KEY: np.random.RandomState(2).uniform(0, 3, (5, 3)),
                _keys.ATOMIC_NUMBERS_KEY: np.array([6, 1, 1, 8, 1])}
    return [lj.get_frame(0), lj.get_frame(1), molecule]


TRANSFORMS = {
    "virial_to_stress": lambda m: (m.VirialToStressTransform(),),
    "stress_sign_flip": lambda m: (m.StressSignFlipTransform(),),
    "add_nan_stress": lambda m: (m.AddNaNStressTransform(),),
    "non_periodic_cell": lambda m: (m.NonPeriodicCellTransform(vacuum=7.5),),
    "dataset_index": lambda m: (m.DatasetIndexTransform(3),),
    "prune": lambda m: (m.ChemicalSpeciesToAtomTypeMapper(["H", "C", "O", "Cu"]), m.NeighborListTransform(3.0),
                        m.NeighborListPruneTransform({"Cu": 2.6, "H": {"C": 1.1}}, ["H", "C", "O", "Cu"], 3.0)),
    "sorted_nl": lambda m: (m.SortedNeighborListTransform(3.0),),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_match_jax(name):
    for frame in _transform_frames():
        if name in ("virial_to_stress", "stress_sign_flip") and _keys.VIRIAL_KEY not in frame:
            continue
        if name in ("prune", "sorted_nl") and _keys.CELL_KEY not in frame:
            continue
        got, want = dict(frame), dict(frame)
        port_t = TRANSFORMS[name](ptr)
        if name in ("prune", "sorted_nl"):  # the JAX transform's neighbour-list backend
            port_t[-2 if name == "prune" else -1].backend = "kdtree"
        for t in port_t:
            got = t(got)
        for t in TRANSFORMS[name](jtr):
            want = t(want)
        _assert_frames_equal(got, want)
    assert set(ptr.__all__) == set(jtr.__all__)


# --- named data modules ------------------------------------------------------------
SYMBOLS = ["H", "C", "N", "O", "Cu"]


def _transforms(mod):
    return [mod.ChemicalSpeciesToAtomTypeMapper(chemical_symbols=SYMBOLS),
            mod.NeighborListTransform(r_max=3.0, **({"backend": "kdtree"} if mod is ptr else {}))]


def _write_frames(path, n, seed=0, info_energy_key=None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.RandomState(seed)
    frames = [
        {
            _keys.POSITIONS_KEY: rng.uniform(0, 3, (3, 3)),
            _keys.ATOMIC_NUMBERS_KEY: np.array([6, 1, 8]),
            _keys.CELL_KEY: np.eye(3) * 6,
            _keys.PBC_KEY: np.array([True] * 3),
            _keys.TOTAL_ENERGY_KEY: np.array([[rng.standard_normal()]]),
            _keys.FORCE_KEY: rng.standard_normal((3, 3)),
        }
        for _ in range(n)
    ]
    jxyz.write_extxyz(path, frames)
    if info_energy_key:  # the Water dataset's key names (TotEnergy, per-atom `force`)
        text = open(path).read()
        open(path, "w").write(text.replace("energy=", f"{info_energy_key}=").replace(":forces:", ":force:"))


def _sgdml_npz(path, seed, keys=("R", "E", "F", "z")):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    r = np.random.RandomState(seed)
    arrays = dict(zip(keys, (r.uniform(0, 3, (10, 4, 3)), r.standard_normal(10), r.standard_normal((10, 4, 3)),
                             np.array([6, 1, 1, 8]))))
    np.savez(path, **arrays)


def _placed(d):
    """Files at each named data module's download path, and its arguments."""
    _write_frames(os.path.join(d, "dataset_3BPA", "train_300K.xyz"), 8, 1)
    for t in ("300K", "600K"):
        _write_frames(os.path.join(d, "dataset_3BPA", f"test_{t}.xyz"), 2, 2)
    base = os.path.join(d, "benchmarking_master_collection")
    _write_frames(os.path.join(base, "Cu_2700cwm_train.xyz"), 6, 3)
    _write_frames(os.path.join(base, "Cu_2700cwm_test.xyz"), 2, 4)
    for i, (name, n) in enumerate([("Trainset", 6), ("Validset", 2), ("Testset", 2), ("OOD", 2)]):
        _write_frames(os.path.join(d, "HfO", f"{name}.xyz"), n, 20 + i)
    _write_frames(os.path.join(d, "dataset_1593_eVAng.xyz"), 10, 7, info_energy_key="TotEnergy")
    for split, n in [("train", 6), ("val", 2), ("test", 2)]:
        _write_frames(os.path.join(d, f"coll_v1.2_AE_{split}.xyz"), n, 11)
    _sgdml_npz(os.path.join(d, "aspirin_ccsd.npz"), 30)
    _sgdml_npz(os.path.join(d, "rmd17_ethanol.npz"), 31, keys=("coords", "energies", "forces", "nuclear_charges"))
    _sgdml_npz(os.path.join(d, "md22_DHA.npz"), 32)
    loaders = dict(train_dataloader={"batch_size": 2}, val_dataloader={"batch_size": 1},
                   test_dataloader={"batch_size": 1})
    npz = dict(train=6, val=2, test=2, seed=5, **loaders)
    return {
        "3bpa": ("NequIP3BPADataModule", dict(seed=1, train_val_split=[6, 2], data_source_dir=d,
                                              test_sets=["300K", "600K"], **loaders), 2),
        "tm23": ("TM23DataModule", dict(seed=1, data_source_dir=d, element="Cu", train_val_split=[4, 2], **loaders), 1),
        "samd23": ("SAMD23DataModule", dict(seed=1, data_source_dir=d, system="HfO", include_ood=True, **loaders), 2),
        "water": ("WaterDataModule", dict(seed=1, data_source_dir=d, train_val_test_split=[6, 2, 2], **loaders), 1),
        "coll": ("COLLDataModule", dict(seed=1, data_source_dir=d, **loaders), 1),
        "npz_split": ("NPZSplitDataModule", dict(file_path=os.path.join(d, "aspirin_ccsd.npz"), **npz), 1),
        "sgdml": ("sGDML_CCSD_DataModule", dict(dataset="aspirin_ccsd", data_source_dir=d, **npz), 1),
        "rmd17": ("rMD17DataModule", dict(dataset="ethanol", data_source_dir=d, **npz), 1),
        "md22": ("MD22DataModule", dict(dataset="DHA", data_source_dir=d, **npz), 1),
    }


@pytest.mark.parametrize("name", ["3bpa", "tm23", "samd23", "water", "coll", "npz_split", "sgdml", "rmd17", "md22"])
def test_named_datamodule_matches_jax(tmp_path, name):
    cls_name, kwargs, n_tests = _placed(str(tmp_path))[name]
    want = getattr(jdm, cls_name)(transforms=_transforms(jtr), **kwargs)
    got = getattr(pdm, cls_name)(transforms=_transforms(ptr), device="cpu", **kwargs)
    for stage in ("fit", "test"):
        want.setup(stage)
        got.setup(stage)
    assert {k: len(v) for k, v in got.datasets.items()} == {k: len(v) for k, v in want.datasets.items()}
    for split, datasets in want.datasets.items():
        for g, w in zip(got.datasets[split], datasets):
            assert getattr(g, "indices", None) == getattr(w, "indices", None), split
            _assert_datasets_equal(g, w)
    batch = next(iter(got.train_dataloader()))
    assert _keys.POSITIONS_KEY in batch and np.isfinite(batch[_keys.TOTAL_ENERGY_KEY].numpy()).any()
    assert len(got.test_dataloaders()) == n_tests


def test_ase_datamodule_takes_a_list_of_validation_files(tmp_path):
    paths = [str(tmp_path / f"{name}.xyz") for name in ("train", "val_a", "val_b")]
    for i, p in enumerate(paths):
        _write_frames(p, 4 - i, 40 + i)
    kwargs = dict(seed=2, train_file_path=paths[0], val_file_path=paths[1:],
                  train_dataloader={"batch_size": 2}, val_dataloader={"batch_size": 1})
    want = jdm.ASEDataModule(transforms=_transforms(jtr), **kwargs)
    got = pdm.ASEDataModule(transforms=_transforms(ptr), device="cpu", **kwargs)
    want.setup("fit")
    got.setup("fit")
    vals = got.val_dataloaders()
    assert [len(v.dataset) for v in vals] == [len(v.dataset) for v in want.val_dataloaders()] == [3, 2]
    for g, w in zip(got.datasets["val"], want.datasets["val"]):
        _assert_datasets_equal(g, w)


def test_offline_download_error_is_unchanged(tmp_path, monkeypatch):
    def offline(url, dest):
        raise OSError("no network")

    monkeypatch.setattr(urllib.request, "urlretrieve", offline)
    errors = []
    for mod in (jdm, pdm):
        dm = mod.COLLDataModule(seed=1, transforms=[], data_source_dir=str(tmp_path), **({"device": "cpu"} if mod is pdm else {}))
        with pytest.raises(RuntimeError, match="offline|download|place the file") as err:
            dm.prepare_data()
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert "could not download https://figshare.com/ndownloader/files/" in errors[1]
