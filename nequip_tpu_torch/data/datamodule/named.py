"""Named benchmark data modules (sGDML/aspirin, rMD17, MD22, 3BPA, TM23,
SAMD23, Water, COLL).

Port of ``nequip_tpu/data/datamodule/named.py``: thin wrappers that know
each dataset's file layout, key mapping and download URL, with the same
split indices and frames.  A download needs the network; with the files
already in place under ``data_source_dir`` (or ``file_path``) everything
runs offline, and a failed download says where to put the file.
"""

from __future__ import annotations

import os
import urllib.request
import zipfile
from typing import List, Optional, Sequence

from .base import NequIPDataModule

_SGDML_URL = "http://www.quantum-machine.org/gdml/data/npz/{name}.npz"
_RMD17_NAMES = [
    "aspirin", "azobenzene", "benzene", "ethanol", "malonaldehyde",
    "naphthalene", "paracetamol", "salicylic", "toluene", "uracil",
]
_MD22_NAMES = [
    "Ac-Ala3-NHMe", "DHA", "stachyose", "AT-AT", "AT-AT-CG-CG",
    "buckyball-catcher", "double-walled_nanotube",
]


def _maybe_download(url: str, dest: str) -> str:
    if os.path.exists(dest):
        return dest
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    try:
        urllib.request.urlretrieve(url, dest)  # nosec - user-requested dataset
    except Exception as e:
        raise RuntimeError(
            f"could not download {url} (offline environment?); place the file "
            f"at {dest} manually"
        ) from e
    return dest


class NPZSplitDataModule(NequIPDataModule):
    """Split one NPZ trajectory into train/val/test."""

    def __init__(
        self,
        file_path: str,
        transforms: Sequence = (),
        train: int = 950,
        val: int = 50,
        test: int = 0,
        seed: int = 123,
        key_mapping: Optional[dict] = None,
        **kwargs,
    ):
        split = {
            "dataset": {
                "_target_": "nequip_tpu_torch.data.dataset.NPZDataset",
                "file_path": file_path,
                "key_mapping": key_mapping,
                "transforms": list(transforms),
            },
            "train": train,
            "val": val,
        }
        if test:
            split["test"] = test
        super().__init__(seed=seed, split_dataset=split, **kwargs)


def sGDML_CCSD_DataModule(
    dataset: str = "aspirin_ccsd",
    data_source_dir: str = "./data",
    transforms: Sequence = (),
    **kwargs,
) -> NPZSplitDataModule:
    """CCSD(T) sGDML molecules (the tutorial-aspirin data).

    Downloads ``{dataset}.npz`` from quantum-machine.org on first use.
    """
    # sGDML ships train/test zips; the plain npz covers the common case
    path = os.path.join(data_source_dir, f"{dataset}.npz")
    if not os.path.exists(path):
        # the train-split archive of the sGDML site
        url = _SGDML_URL.format(name=dataset + "-train")
        try:
            zpath = _maybe_download(url.replace(".npz", ".zip"), path + ".zip")
            with zipfile.ZipFile(zpath) as zf:
                names = [n for n in zf.namelist() if n.endswith(".npz")]
                zf.extract(names[0], data_source_dir)
                os.rename(os.path.join(data_source_dir, names[0]), path)
        except Exception:
            _maybe_download(_SGDML_URL.format(name=dataset), path)
    return NPZSplitDataModule(file_path=path, transforms=transforms, **kwargs)


def rMD17DataModule(
    dataset: str = "aspirin",
    data_source_dir: str = "./data",
    transforms: Sequence = (),
    **kwargs,
) -> NPZSplitDataModule:
    assert dataset in _RMD17_NAMES, f"unknown rMD17 molecule {dataset!r}"
    path = os.path.join(data_source_dir, f"rmd17_{dataset}.npz")
    if not os.path.exists(path):
        raise RuntimeError(
            f"rMD17 requires a manual download (figshare); place rmd17_{dataset}.npz at {path}"
        )
    return NPZSplitDataModule(
        file_path=path,
        transforms=transforms,
        key_mapping={
            "coords": "pos",
            "energies": "total_energy",
            "forces": "forces",
            "nuclear_charges": "atomic_numbers",
        },
        **kwargs,
    )


def MD22DataModule(
    dataset: str = "Ac-Ala3-NHMe",
    data_source_dir: str = "./data",
    transforms: Sequence = (),
    **kwargs,
) -> NPZSplitDataModule:
    assert dataset in _MD22_NAMES, f"unknown MD22 system {dataset!r}"
    path = os.path.join(data_source_dir, f"md22_{dataset}.npz")
    _maybe_download(_SGDML_URL.format(name=f"md22_{dataset}"), path)
    return NPZSplitDataModule(file_path=path, transforms=transforms, **kwargs)


# ---------------------------------------------------------------------------
# ASE-file benchmark datamodules (3BPA / TM23 / SAMD23 / Water / COLL)
# ---------------------------------------------------------------------------
from .ase import ASEDataModule  # noqa: E402

_URL_3BPA = (
    "https://github.com/davkovacs/BOTNet-datasets/raw/refs/heads/main/"
    "dataset_3BPA.tar.gz"
)
_3BPA_TEST_SETS = [
    "300K", "600K", "1200K", "dih_beta120", "dih_beta150", "dih_beta180",
]
_URL_TM23 = (
    "https://archive.materialscloud.org/records/tcrks-ymp88/files/"
    "benchmarking_master_collection-20240316T202423Z-001.zip?download=1"
)
_TM23_ELEMENTS = [
    "Ag", "Au", "Cd", "Co", "Cr", "Cu", "Fe", "Hf", "Hg", "Ir", "Mn", "Mo",
    "Nb", "Ni", "Os", "Pd", "Pt", "Re", "Rh", "Ru", "Ta", "Tc", "Ti", "V",
    "W", "Zn", "Zr",
]
_SAMD23_URLS = {
    "HfO": "https://drive.google.com/uc?id=1-DVMGyXjvNYaBtaAkWu8uQVgvz8pEgMZ",
    "SiN": "https://drive.google.com/uc?id=1l9nsie40Bpm8CNW4sx94yAuvmMkUfM3b",
}
_URL_WATER = (
    "https://github.com/BingqingCheng/Mapping-the-space-of-materials-and-"
    "molecules/raw/refs/heads/master/mlp-water/dataset_1593_eVAng.xyz"
)
_COLL_URLS = {
    "coll_v1.2_AE_train.xyz": "https://figshare.com/ndownloader/files/25605734",
    "coll_v1.2_AE_val.xyz": "https://figshare.com/ndownloader/files/25605737",
    "coll_v1.2_AE_test.xyz": "https://figshare.com/ndownloader/files/25605740",
}


def _extract(archive: str, dest_dir: str) -> None:
    import tarfile

    if archive.endswith((".tar.gz", ".tgz", ".tar")):
        with tarfile.open(archive) as tf:
            tf.extractall(dest_dir)  # nosec - user-requested dataset
    else:
        with zipfile.ZipFile(archive) as zf:
            zf.extractall(dest_dir)  # nosec


class NequIP3BPADataModule(ASEDataModule):
    """3BPA flexible-molecule benchmark (Kovacs et al. JCTC 2021).

    ``train_set`` in {300K, mixedT}; test sets default to all six published
    splits.  Auto-downloads ``dataset_3BPA.tar.gz`` into ``data_source_dir``
    (offline: place/extract it there manually).
    """

    def __init__(
        self,
        seed: int,
        transforms: Sequence,
        train_val_split: Sequence,
        data_source_dir: str,
        train_set: str = "300K",
        test_sets: Optional[List[str]] = None,
        **kwargs,
    ):
        assert train_set in ("300K", "mixedT")
        test_sets = _3BPA_TEST_SETS if test_sets is None else list(test_sets)
        assert all(t in _3BPA_TEST_SETS for t in test_sets)
        self.data_source_dir = data_source_dir
        self.train_file_path = os.path.join(
            data_source_dir, "dataset_3BPA", f"train_{train_set}.xyz"
        )
        self.test_file_paths = [
            os.path.join(data_source_dir, "dataset_3BPA", f"test_{t}.xyz")
            for t in test_sets
        ]
        super().__init__(
            seed=seed,
            split_dataset={
                "file_path": self.train_file_path,
                "train": train_val_split[0],
                "val": train_val_split[1],
            },
            test_file_path=self.test_file_paths,
            transforms=transforms,
            **kwargs,
        )

    def prepare_data(self) -> None:
        needed = [self.train_file_path] + self.test_file_paths
        if not all(os.path.isfile(p) for p in needed):
            archive = _maybe_download(
                _URL_3BPA, os.path.join(self.data_source_dir, "dataset_3BPA.tar.gz")
            )
            _extract(archive, self.data_source_dir)

    def setup(self, stage=None) -> None:
        self.prepare_data()
        super().setup(stage)


class TM23DataModule(ASEDataModule):
    """TM23 transition-metal benchmark (Owen et al. npj Comput. Mater. 2024).

    Per-element ``*_2700cwm_train/test.xyz`` pairs from the Materials Cloud
    collection; ``train_val_split`` splits the train file.
    """

    def __init__(
        self,
        seed: int,
        data_source_dir: str,
        element: str,
        transforms: Sequence,
        train_val_split: Sequence,
        **kwargs,
    ):
        assert element in _TM23_ELEMENTS, f"unsupported TM23 element {element!r}"
        self.data_source_dir = data_source_dir
        base = os.path.join(data_source_dir, "benchmarking_master_collection")
        self.train_file_path = os.path.join(base, f"{element}_2700cwm_train.xyz")
        self.test_file_path = os.path.join(base, f"{element}_2700cwm_test.xyz")
        super().__init__(
            seed=seed,
            split_dataset={
                "file_path": self.train_file_path,
                "train": train_val_split[0],
                "val": train_val_split[1],
            },
            test_file_path=self.test_file_path,
            transforms=transforms,
            **kwargs,
        )

    def prepare_data(self) -> None:
        if not (
            os.path.isfile(self.train_file_path)
            and os.path.isfile(self.test_file_path)
        ):
            archive = _maybe_download(
                _URL_TM23, os.path.join(self.data_source_dir, "tm23.zip")
            )
            _extract(archive, self.data_source_dir)

    def setup(self, stage=None) -> None:
        self.prepare_data()
        super().setup(stage)


class SAMD23DataModule(ASEDataModule):
    """Samsung SAMD23 HfO/SiN benchmark with pre-split Train/Valid/Test files.

    ``include_ood=True`` adds ``OOD.xyz`` as a second test set.  The archive
    lives on Google Drive; automatic download needs the optional ``gdown``
    package, otherwise download/extract manually into
    ``data_source_dir/<system>/``.
    """

    def __init__(
        self,
        seed: int,
        transforms: Sequence,
        data_source_dir: str,
        system: str = "HfO",
        include_ood: bool = True,
        **kwargs,
    ):
        system = system.strip()
        assert system in _SAMD23_URLS, (
            f"unknown system {system!r}; must be one of {sorted(_SAMD23_URLS)}"
        )
        self.system = system
        self.data_source_dir = data_source_dir
        self.dataset_dir = os.path.join(data_source_dir, system)
        self.include_ood = include_ood
        self.train_file_path = os.path.join(self.dataset_dir, "Trainset.xyz")
        self.val_file_path = os.path.join(self.dataset_dir, "Validset.xyz")
        self.ood_path = os.path.join(self.dataset_dir, "OOD.xyz")
        test_file_paths = [os.path.join(self.dataset_dir, "Testset.xyz")]
        if include_ood:
            test_file_paths.append(self.ood_path)
        self.test_file_paths = test_file_paths
        super().__init__(
            seed=seed,
            train_file_path=self.train_file_path,
            val_file_path=self.val_file_path,
            test_file_path=test_file_paths,
            transforms=transforms,
            **kwargs,
        )

    def prepare_data(self) -> None:
        required = [
            self.train_file_path,
            self.val_file_path,
            os.path.join(self.dataset_dir, "Testset.xyz"),
        ]
        if all(os.path.isfile(p) for p in required):
            return
        archive = os.path.join(self.data_source_dir, f"{self.system}.tar")
        if not os.path.isfile(archive):
            try:
                import gdown  # optional dependency
            except ImportError as e:
                raise RuntimeError(
                    f"SAMD23 lives on Google Drive; install `gdown` or place "
                    f"the extracted {self.system}/ directory under "
                    f"{self.data_source_dir}"
                ) from e
            gdown.download(_SAMD23_URLS[self.system], archive, quiet=False)
        _extract(archive, self.data_source_dir)

    def setup(self, stage=None) -> None:
        self.prepare_data()
        super().setup(stage)


class WaterDataModule(ASEDataModule):
    """Cheng et al. liquid-water dataset (1593 frames, eV/Å units).

    One extxyz file split train/val/test; energies under ``TotEnergy`` and
    forces under ``force``.
    """

    def __init__(
        self,
        seed: int,
        transforms: Sequence,
        data_source_dir: str,
        train_val_test_split: Sequence,
        **kwargs,
    ):
        assert len(train_val_test_split) == 3
        self.data_source_dir = data_source_dir
        self.file_path = os.path.join(data_source_dir, "dataset_1593_eVAng.xyz")
        super().__init__(
            seed=seed,
            split_dataset={
                "file_path": self.file_path,
                "train": train_val_test_split[0],
                "val": train_val_test_split[1],
                "test": train_val_test_split[2],
            },
            transforms=transforms,
            key_mapping={"TotEnergy": "total_energy", "force": "forces"},
            **kwargs,
        )

    def prepare_data(self) -> None:
        if not os.path.isfile(self.file_path):
            _maybe_download(_URL_WATER, self.file_path)

    def setup(self, stage=None) -> None:
        self.prepare_data()
        super().setup(stage)


class COLLDataModule(ASEDataModule):
    """COLL molecular-collision benchmark (Gasteiger et al.), pre-split files."""

    def __init__(
        self,
        seed: int,
        transforms: Sequence,
        data_source_dir: str,
        **kwargs,
    ):
        self.data_source_dir = data_source_dir
        self.train_file_path = os.path.join(data_source_dir, "coll_v1.2_AE_train.xyz")
        self.val_file_path = os.path.join(data_source_dir, "coll_v1.2_AE_val.xyz")
        self.test_file_path = os.path.join(data_source_dir, "coll_v1.2_AE_test.xyz")
        super().__init__(
            seed=seed,
            train_file_path=self.train_file_path,
            val_file_path=self.val_file_path,
            test_file_path=self.test_file_path,
            transforms=transforms,
            **kwargs,
        )

    def prepare_data(self) -> None:
        for fname, url in _COLL_URLS.items():
            path = os.path.join(self.data_source_dir, fname)
            if not os.path.isfile(path):
                _maybe_download(url, path)

    def setup(self, stage=None) -> None:
        self.prepare_data()
        super().setup(stage)
