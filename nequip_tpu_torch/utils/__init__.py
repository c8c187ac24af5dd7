from .config import instantiate, load_config, locate, register_resolver, resolve
from .dtype import default_dtype, dtype_from_name, dtype_to_name, get_default_dtype, model_tolerance
from .global_state import get_latest_global_state, set_global_state, set_tf32
from .logger import RankedLogger
from .profiling import TorchProfilerCallback, flops_per_step, mfu, trace
from .versions import check_version_compatibility, get_current_code_versions

__all__ = [
    "default_dtype",
    "dtype_from_name",
    "dtype_to_name",
    "get_default_dtype",
    "model_tolerance",
    "set_global_state",
    "set_tf32",
    "get_latest_global_state",
    "instantiate",
    "resolve",
    "load_config",
    "register_resolver",
    "locate",
    "RankedLogger",
    "flops_per_step",
    "mfu",
    "trace",
    "TorchProfilerCallback",
    "get_current_code_versions",
    "check_version_compatibility",
]
