"""Every field of the port's ``VOConfig`` is read somewhere in ``lcvo_tpu_torch/``
outside ``config.py`` (the port's twin of tests/test_config_usage.py, same pattern).

No field is an exception: ``runtime.donate_state``, the last one the port did not read,
reaches ``utils/graphs.compile_step`` (the port's ``jax.jit`` with ``donate_argnums``)
through ``VisualOdometry`` and ``parallel/streams.py``.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re

import pytest

from lcvo_tpu.config import VOConfig as JVOConfig
from lcvo_tpu_torch.config import VOConfig

PKG = pathlib.Path(__file__).resolve().parent.parent / "lcvo_tpu_torch"
IGNORED_BY_THE_PORT: set[str] = set()


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


@pytest.mark.parametrize("donate", [True, False])
def test_donate_state_reaches_compile_step(donate):
    """``runtime.donate_state`` is what the compiled steps of the host loop and of the
    ``make_multistream_*`` functions donate by (those of a state; the uniforms of the keys
    take no state and donate nothing), and ``config.py`` no longer says the port ignores it."""
    import numpy as np

    from lcvo_tpu_torch.config import load_config
    from lcvo_tpu_torch.parallel import streams
    from lcvo_tpu_torch.pipeline import VisualOdometry
    from lcvo_tpu_torch.utils import graphs

    cfg = load_config(overrides={"runtime": {"donate_state": donate},
                                 "ba": {"enabled": True}})
    vo = VisualOdometry(cfg, np.eye(3), device="cpu")
    assert isinstance(vo._process, graphs.CompiledStep)
    assert vo._process.donate is donate and vo._ba.donate is donate
    assert vo._uniforms.compiled.donate is False
    seen = []
    real = graphs.CompiledStep.__init__

    def spy(self, fn, **kw):
        seen.append((kw.get("name"), kw["donate"]))
        real(self, fn, **kw)

    graphs.CompiledStep.__init__ = spy
    try:
        streams.make_multistream_step(cfg, np.eye(3), device="cpu")
        streams.make_multistream_chunk_step(cfg, np.eye(3), device="cpu")
    finally:
        graphs.CompiledStep.__init__ = real
    assert [d for n, d in seen if n != "pnp_uniforms"] == [donate] * 3
    assert [d for n, d in seen if n == "pnp_uniforms"] == [False] * 2
    assert "port ignores it" not in (PKG / "config.py").read_text()


def test_the_port_has_the_jax_package_fields():
    """The same leaf fields as the JAX package's ``VOConfig``: a YAML file of either
    package loads into the other."""
    assert _leaf_field_names(VOConfig) == _leaf_field_names(JVOConfig)
