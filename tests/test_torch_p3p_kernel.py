"""The ``lcvo::p3p`` operator on the CPU: the plain P3P solve behind the operator that
launches ``csrc/p3p.cu`` on the card.

The CPU path must be the P3P code as it was before the operator existed, bit for bit:
that code is ``ops/pnp.py::p3p_grunert_plain``, moved there unchanged, and the JAX
parity tests of ``tests/test_torch_geometry.py`` hold it to the JAX package. The kernel
itself runs only on a card (``chip_smoke.py``, ``[kernel] p3p``)."""

import numpy as np
import pytest
import torch

from lcvo_tpu_torch import kernels
from lcvo_tpu_torch.data import minimal_sets
from lcvo_tpu_torch.ops import pnp


def _sets(kind, n=64, seed=0):
    kind = "scene" if kind == "random" else kind
    Pw, f = minimal_sets.p3p_sets(kind, n, np.random.default_rng(seed))
    return torch.from_numpy(Pw), torch.from_numpy(f)


def _plain_roots(monkeypatch, Pw, f):
    """The plain version's outputs and the quartic roots it found."""
    roots = []
    solve = pnp.quartic_roots
    monkeypatch.setattr(pnp, "quartic_roots", lambda c: roots.append(solve(c)) or roots[-1])
    out = pnp.p3p_grunert_plain(Pw, f)
    monkeypatch.setattr(pnp, "quartic_roots", solve)
    return out, roots[0]


def _bits_equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        ((a == b) | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("kind", ["random", "double", "near_double"])
def test_p3p_op_on_cpu_is_the_frozen_plain_code(kind, monkeypatch):
    """``p3p_grunert`` (the operator) on CPU tensors = the plain code it replaced, bit for
    bit, also where the quartic's roots cluster and Durand-Kerner is most sensitive."""
    Pw, f = _sets(kind)
    got = pnp.p3p_grunert(Pw, f)
    want, roots = _plain_roots(monkeypatch, Pw, f)
    assert all(_bits_equal(g, w) for g, w in zip(got, want))
    assert got[0].shape == (64, 4, 3, 3) and got[1].shape == (64, 4, 3)
    assert got[2].dtype == torch.bool and got[2].any()
    if kind != "random":     # the sets are clustered: some root is near v = 1 twice
        v = torch.sort(roots.real, dim=-1).values
        assert float(torch.diff(v, dim=-1).abs().min(dim=-1).values.median()) < 0.05


@pytest.mark.parametrize("in_dims", [(0, 0), (0, None), (1, 1)])
def test_p3p_vmap_rule_equals_the_stream_loop(in_dims):
    """Under ``torch.func.vmap`` (the batched streams' step) S calls are one call on the
    stacked batch, equal to calling each stream alone, at the step's 512 sets."""
    S = 3
    sets = [_sets("random", 512, seed=s) for s in range(S)]
    Pw = torch.stack([p for p, _ in sets])
    f = torch.stack([q for _, q in sets])
    if in_dims[1] is None:
        f = f[0]
    per_stream = [pnp.p3p_grunert(Pw[s], f if in_dims[1] is None else f[s]) for s in range(S)]
    if in_dims[0] == 1:
        Pw, f = Pw.movedim(0, 1), f.movedim(0, 1)
    got = torch.func.vmap(pnp.p3p_grunert, in_dims=in_dims)(Pw, f)
    for k in range(3):
        assert _bits_equal(got[k], torch.stack([r[k] for r in per_stream]))


def test_p3p_vmap_is_one_call_of_the_operator(monkeypatch):
    """The batching rule calls the operator once with the streams folded into the batch."""
    calls = []
    real = pnp.p3p_grunert_plain
    monkeypatch.setattr(pnp, "p3p_grunert_plain", lambda Pw, f: calls.append(Pw.shape) or real(Pw, f))
    Pw, f = _sets("random", 16)
    torch.func.vmap(pnp.p3p_grunert)(Pw[None].expand(4, -1, -1, -1), f[None].expand(4, -1, -1, -1))
    assert calls == [torch.Size((4, 16, 3, 3))]


@pytest.mark.parametrize("case,exc", [
    ("f64", TypeError), ("f16_bearings", TypeError), ("rows", ValueError),
    ("shape_mismatch", ValueError), ("flat", ValueError), ("devices", ValueError)])
def test_p3p_wrapper_raises(case, exc):
    Pw, f = _sets("random", 4)
    args = {"f64": (Pw.double(), f.double()), "f16_bearings": (Pw, f.half()),
            "rows": (Pw[..., :2, :], f[..., :2, :]), "shape_mismatch": (Pw, f[:3]),
            "flat": (Pw[0, 0], f[0, 0]), "devices": (Pw, f.to("meta"))}[case]
    with pytest.raises(exc):
        pnp.p3p_grunert(*args)


def test_p3p_launch_counter_is_zero_on_cpu():
    """The counter exists and counts kernel launches only: a CPU call adds nothing."""
    assert "p3p" in kernels.LAUNCHES
    kernels.reset_launches()
    Pw, f = _sets("random", 8)
    pnp.p3p_grunert(Pw, f)
    torch.func.vmap(pnp.p3p_grunert)(Pw[None], f[None])
    assert kernels.LAUNCHES["p3p"] == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_pnp_ransac_on_cpu_is_the_frozen_plain_code(seed, monkeypatch):
    """PnP-RANSAC through the operator = PnP-RANSAC with the plain P3P called directly, as
    before the operator existed, bit for bit, with the same injected minimal sets."""
    rng = np.random.default_rng(seed)
    N = 200
    X = rng.normal(size=(N, 3)) * np.array([5, 3, 4]) + np.array([0, 0, 15.0])
    Xc = X @ minimal_sets.rotations(rng, 1, 0.1)[0].T + rng.normal(size=3) * 0.5
    x = Xc[:, :2] / Xc[:, 2:] + rng.normal(size=(N, 2)) * 0.5 / 718.0
    x[:30] += rng.uniform(0.02, 0.08, size=(30, 2))
    X, x = torch.from_numpy(X.astype(np.float32)), torch.from_numpy(x.astype(np.float32))
    valid = torch.from_numpy(rng.random(N) > 0.05)
    idx = torch.from_numpy(np.stack([rng.choice(N, 3, replace=False) for _ in range(256)]))
    got = pnp.pnp_ransac(None, X, x, valid, thresh=2.0 / 718.0, n_hyp=256, idx=idx)
    monkeypatch.setattr(pnp, "p3p_grunert", pnp.p3p_grunert_plain)
    want = pnp.pnp_ransac(None, X, x, valid, thresh=2.0 / 718.0, n_hyp=256, idx=idx)
    assert all(_bits_equal(g, w) for g, w in zip(got, want))
    assert int(got[3]) > 150
