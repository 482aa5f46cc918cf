"""Every field of the port's ``VOConfig`` is read somewhere in ``lcvo_tpu_torch/``
outside ``config.py`` (the port's twin of tests/test_config_usage.py, same pattern).

One field is named as the exception: ``runtime.donate_state`` donates the state buffer
to a jitted step in the JAX package, and eager PyTorch has nothing to donate it to. The
field stays, so that one YAML file loads into both packages, and ``config.py`` says the
port ignores it (ROADMAP §C, differences by design).
"""

from __future__ import annotations

import dataclasses
import pathlib
import re

from lcvo_tpu.config import VOConfig as JVOConfig
from lcvo_tpu_torch.config import VOConfig

PKG = pathlib.Path(__file__).resolve().parent.parent / "lcvo_tpu_torch"
IGNORED_BY_THE_PORT = {"donate_state"}


def _leaf_field_names(cls) -> set[str]:
    names = set()
    for f in dataclasses.fields(cls):
        default = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default
        if dataclasses.is_dataclass(default):
            names |= _leaf_field_names(type(default))
        else:
            names.add(f.name)
    return names


def _unread(names) -> list[str]:
    sources = "".join(p.read_text() for p in PKG.rglob("*.py") if p.name != "config.py")
    # attribute read (cfg.x / det.x), keyword use, or dict key ("x": ...)
    return sorted(n for n in names
                  if not re.search(rf"(\.{n}\b|\b{n}\s*=|[\"']{n}[\"'])", sources))


def test_every_config_field_is_read_outside_config_py():
    unused = _unread(_leaf_field_names(VOConfig) - IGNORED_BY_THE_PORT)
    assert not unused, f"config fields never read outside config.py: {unused}"


def test_the_named_exception_is_unread_and_said_so_in_config_py():
    """The exception is still unread (a port that starts reading it drops it from the
    list), and ``config.py`` says that the port ignores it."""
    assert _unread(IGNORED_BY_THE_PORT) == sorted(IGNORED_BY_THE_PORT)
    text = (PKG / "config.py").read_text()
    for name in IGNORED_BY_THE_PORT:
        assert re.search(rf"{name}.*\n(\s*#.*\n)*\s*#.*port ignores it", text), name


def test_the_port_has_the_jax_package_fields():
    """The same leaf fields as the JAX package's ``VOConfig``: a YAML file of either
    package loads into the other."""
    assert _leaf_field_names(VOConfig) == _leaf_field_names(JVOConfig)
