"""POSH ``_SAFE`` / ``_DEBUG`` modes (counterpart of ``repro.core.safety``).

The paper compiles safety checks in or out with cpp macros (§4.7).  The
port keeps them as host-side flags: with ``safe_mode(True)`` every
collective checks its argument's shape (the paper's "buffer size equals
data size" check, §4.5.5) and refuses to start while another collective
on the same team is in progress; ``debug_mode(True)`` prints a progress
line around each collective (POSH's ``_DEBUG`` logging).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any

_state = threading.local()


def _flags():
    if not hasattr(_state, "safe"):
        _state.safe = False
        _state.debug = False
        _state.in_progress = []  # stack of (team_axes, op_tag)
    return _state


def safe_mode(enabled: bool = True) -> None:
    _flags().safe = enabled


def debug_mode(enabled: bool = True) -> None:
    _flags().debug = enabled


def is_safe() -> bool:
    return _flags().safe


def is_debug() -> bool:
    return _flags().debug


class PoshSafetyError(RuntimeError):
    pass


@contextlib.contextmanager
def collective_guard(team_axes: tuple[str, ...], op_tag: str):
    """Re-entrancy guard (paper §4.7: "check that when a process wants
    to run a collective communication, it is not already participating
    to another collective communication").  Exit removes exactly THIS
    guard's frame, so a raise out of a nested collective cannot strip
    another guard's frame."""
    st = _flags()
    if st.safe:
        for axes, tag in st.in_progress:
            if set(axes) & set(team_axes):
                raise PoshSafetyError(
                    f"collective '{op_tag}' on {team_axes} started while "
                    f"'{tag}' on {axes} is in progress"
                )
    entry = (team_axes, op_tag)
    st.in_progress.append(entry)
    try:
        if st.debug:
            print(f"posh: >> {op_tag} on {team_axes}", flush=True)
        yield
        if st.debug:
            print(f"posh: << {op_tag} on {team_axes}", flush=True)
    finally:
        for i in range(len(st.in_progress) - 1, -1, -1):
            if st.in_progress[i] is entry:
                del st.in_progress[i]
                break


def check_symmetric_arg(x: Any, op_tag: str) -> None:
    """Shape checks, only in safe mode (POSH's ``_SAFE``)."""
    if not is_safe():
        return
    if not hasattr(x, "shape"):
        raise PoshSafetyError(f"{op_tag}: argument is not an array: {type(x)}")
    if any(d <= 0 for d in x.shape):
        raise PoshSafetyError(f"{op_tag}: degenerate buffer shape "
                              f"{tuple(x.shape)}")


def check_same_size(a, b, op_tag: str) -> None:
    if not is_safe():
        return
    if a.numel() != b.numel():
        raise PoshSafetyError(
            f"{op_tag}: buffer size mismatch {tuple(a.shape)} vs "
            f"{tuple(b.shape)} (paper §4.5.5 run-time error checking)"
        )
