"""Small host utilities (env-var config getters, formatting).

Behavioral spec: ref src/utils.cc:27-68.
"""

from __future__ import annotations

import os


def device_name(env=None) -> str:
    """The device type TIMG_TPU_TORCH_DEVICE names, stripped and in lower
    case, ``cuda`` when unset or empty (read here, without torch, by the
    launcher, the fast path's gate, the server and ops/backend.py)."""
    env = os.environ if env is None else env
    return env.get("TIMG_TPU_TORCH_DEVICE", "cuda").strip().lower() or "cuda"


def get_bool_env(name: str, default: bool = False) -> bool:
    """ref utils.cc:27-32: >0 integer, 'on' or 'yes' (case-insensitive)."""
    value = os.environ.get(name)
    if value is None:
        return default
    try:
        if int(value) > 0:
            return True
    except ValueError:
        pass
    return value.lower() in ("on", "yes")


def get_float_env(name: str, default: float) -> float:
    """ref utils.cc:34-40."""
    value = os.environ.get(name)
    if value is None:
        return default
    try:
        return float(value)
    except ValueError:
        return default


def get_int_env(name: str, default: int) -> int:
    """ref utils.cc:42-48."""
    value = os.environ.get(name)
    if value is None:
        return default
    try:
        return int(value, 10)
    except ValueError:
        return default


def human_readable_byte_value(byte_count: float) -> str:
    """ref utils.cc:50-68."""
    print_bytes = float(byte_count)
    unit = "Bytes"
    if print_bytes > (10 << 30):
        print_bytes /= 1 << 30
        unit = "GiB"
    elif print_bytes > (10 << 20):
        print_bytes /= 1 << 20
        unit = "MiB"
    elif print_bytes > (10 << 10):
        print_bytes /= 1 << 10
        unit = "KiB"
    return f"{print_bytes:.1f} {unit}"
