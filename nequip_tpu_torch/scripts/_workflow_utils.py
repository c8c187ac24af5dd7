"""Process-wide workflow state ("train", "package", "compile" or None),
which model loaders consult.

Port of ``nequip_tpu/scripts/_workflow_utils.py``.
"""

_WORKFLOW_STATE = None


def set_workflow_state(state):
    global _WORKFLOW_STATE
    if state not in ("train", "package", "compile", None):
        raise ValueError(f"unknown workflow state {state!r}")
    _WORKFLOW_STATE = state


def get_workflow_state():
    return _WORKFLOW_STATE
