"""The arithmetic the metrics and the check rest on."""

import numpy as np
import pytest
import torch

from vo_bench import check, roofline, stats


@pytest.mark.parametrize("q", [0, 5, 50, 95, 100])
def test_percentile_is_numpys(q):
    x = np.random.default_rng(1).exponential(10.0, 301)
    assert stats.percentile(x, q) == pytest.approx(np.percentile(x, q), rel=1e-12)


def test_rate_counts_the_window_only():
    events = [(1.0, 7), (1.5, 16), (2.0, 16), (2.6, 16)]
    r, work, secs = stats.rate(events, start=0.5, deadline=2.5)
    assert (work, secs) == (39, 1.5) and r == pytest.approx(26.0)


def brute_bytes(img, centers, S, pad):
    H, W = img.shape
    cover = np.zeros((H, W), bool)
    for cx, cy in centers.tolist():
        ox = int(np.clip(np.floor(np.float32(cx) + np.float32(pad)) - (S - 1) // 2, 0, W + 2 * pad - S)) - pad
        oy = int(np.clip(np.floor(np.float32(cy) + np.float32(pad)) - (S - 1) // 2, 0, H + 2 * pad - S)) - pad
        cover[np.clip(np.arange(oy, oy + S), 0, H - 1)[:, None],
              np.clip(np.arange(ox, ox + S), 0, W - 1)[None, :]] = True
    N = len(centers)
    return int(cover.sum()) * 4 + N * 16 + N * S * S * 4


def test_bound_bytes_at_the_default_level0_call():
    """The default path's level-0 target call: 376x1240 f32, N = 2048, S = 29, pad 15."""
    g = torch.Generator().manual_seed(0)
    img = torch.rand((376, 1240), generator=g)
    c = torch.rand((2048, 2), generator=g) * torch.tensor([1240.0 + 58, 376.0 + 58]) - 29
    assert roofline.bound_bytes(img, c, 29, 15) == brute_bytes(img, c, 29, 15)
    # centers dense enough to cover the image: every pixel once
    ys, xs = torch.meshgrid(torch.arange(0, 376, 20.0), torch.arange(0, 1240, 20.0), indexing="ij")
    dense = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)[:2048]
    full = 376 * 1240 * 4 + 2048 * 16 + 2048 * 29 * 29 * 4
    assert roofline.bound_bytes(img, dense, 29, 15) == min(full, brute_bytes(img, dense, 29, 15))


def test_frame_gap():
    c0 = np.zeros(3)
    assert check.frame_gap(np.array([1.0, 0, 0]), np.array([1.0, 0, 0]), c0) == 0.0
    assert check.frame_gap(np.array([1.01, 0, 0]), np.array([1.0, 0, 0]), c0) == pytest.approx(0.01)
    assert check.frame_gap(np.array([np.nan] * 3), np.array([1.0, 0, 0]), c0) == float("inf")
    assert check.frame_gap(np.array([np.nan] * 3), np.array([np.nan] * 3), c0) == 0.0


def test_key_chain_is_the_host_loops():
    from vo_bench.reference.utils import jax_random

    k = jax_random.PRNGKey(2 ** 31 + 11)
    want = []
    for _ in range(5):
        k, sub = jax_random.split(k)
        want.append(sub)
    chain = check.KeyChain(2 ** 31 + 11)
    assert all((chain.key(i + 1) == w).all() for i, w in enumerate(want))


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 1.0 + 3 * 2 ** -11, float("inf")])
    got = check.round_tf32(x)
    assert got.tolist() == [1.0, 1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9, float("inf")]


def test_roofline_reader_takes_the_trace_and_the_calls():
    """The reader picks its kernel's launches out of the raw device events and bounds
    each by the bytes of the reference's call in the same order."""
    from types import SimpleNamespace

    from vo_bench import run

    g = torch.Generator().manual_seed(1)
    img = torch.rand((376, 1240), generator=g)
    c = torch.rand((512, 2), generator=g) * torch.tensor([1240.0, 376.0])
    calls = [((img, c, 29), {"pad": 15}), ((img, c[:100], 59), {})]
    moved = roofline.bound_bytes(img, c, 29, 15) + roofline.bound_bytes(img, c[:100], 59)
    events = [("void extract_blocks_kernel<float>", 10.0, 14.0), ("elementwise", 14.0, 30.0),
              ("void extract_blocks_kernel<float>", 30.0, 36.0)]
    ctx = SimpleNamespace(mode="replay", trace={"device_events": events},
                          calls={"extract_blocks": calls})
    read = run.reader("extract_blocks_roofline.replay")
    assert read(ctx) == pytest.approx(100.0 * moved / roofline.HBM_BYTES_PER_S / 10e-6)
    ctx.calls = {"extract_blocks": calls[:1]}           # a launch the reference did not call
    assert read(ctx) is None
