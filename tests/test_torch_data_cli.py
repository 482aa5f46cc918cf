"""The port's host layers on the CPU: dataset adapters, the native PNG decoder's binding,
the standard-library PNG writer, the Prefetcher, the dataset tool and the CLI — the
counterparts of tests/test_data_cli.py and tests/test_native_loader.py, and the on-disk
interfaces read by both packages (one directory, both adapters; one PNG, three decoders;
one KITTI-layout dataset, both CLIs)."""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from PIL import Image

from lcvo_tpu.data import datasets as jdatasets
from lcvo_tpu.data import native_loader as jnative
from lcvo_tpu_torch.cli import run as cli
from lcvo_tpu_torch.data import datasets as tdatasets
from lcvo_tpu_torch.data import native_loader
from lcvo_tpu_torch.data.datasets import (Prefetcher, SyntheticDataset, _imread_gray,
                                          imwrite_gray_png, kitti, load_dataset, malaga, parking)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# small capacities for the CLI runs (the CLI takes the image size from the first frame
# and the bootstrap gap from the dataset)
SMALL_YAML = textwrap.dedent("""
    state: {max_tracks: 256, max_candidates: 256, max_new_per_frame: 96}
    klt: {window: 15, iters: 8, levels: 3}
    ransac: {e_hypotheses: 256, pnp_hypotheses: 256}
""")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the cores; PyTorch's own thread pool on top of them
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _private_native_library(tmp_path_factory):
    """Both packages' bindings load a native library that this module builds in a
    directory of its own, so nothing here depends on the shared ``native/``: another
    test process may be linking ``native/liblcvo_native.so`` in place at any moment,
    and the JAX package's binding remembers a load that failed for good."""
    work = tmp_path_factory.mktemp("native_lib") / "native"
    work.mkdir()
    for name in ("Makefile", "png_loader.cpp"):
        (work / name).write_bytes(open(os.path.join(ROOT, "native", name), "rb").read())
    lib_path = str(work / "liblcvo_native.so")
    fields = {native_loader: ("_LIB_PATH", "_lib", "_tried", "_error"),
              jnative: ("_LIB_PATH", "_lib", "_tried")}
    saved = {(m, f): getattr(m, f) for m, names in fields.items() for f in names}
    native_loader._LIB_PATH = lib_path
    native_loader._build()    # a failure is built again, and kept, at the first load
    for m in fields:
        m._LIB_PATH, m._lib, m._tried = lib_path, None, False
    native_loader._error = None
    yield
    for (m, f), v in saved.items():
        setattr(m, f, v)


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small_yaml(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "small.yaml"
    p.write_text(SMALL_YAML)
    return str(p)


@pytest.fixture(scope="module")
def corridor_root(tmp_path_factory):
    """A 40-frame 256x96 corridor in the KITTI layout, written by the port's dataset
    tool (its renderer on the CPU, its PNG writer)."""
    root = tmp_path_factory.mktemp("corridor")
    rep = _tool("port_make_replay_dataset").make_dataset(
        "kitti", frames=40, out=str(root), device="cpu", size=(256, 96))
    assert rep["written"] == 40 and rep["render_s"] > 0 and rep["encode_s"] > 0
    return str(root)


@pytest.fixture
def kitti_root(tmp_path):
    root = tmp_path / "kitti-dataset"
    (root / "05" / "image_0").mkdir(parents=True)
    (root / "poses").mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        imwrite_gray_png(str(root / "05" / "image_0" / f"{i:06d}.png"),
                         rng.uniform(0, 255, (37, 124)).astype(np.uint8))
    poses = []
    for i in range(8):
        P = np.hstack([np.eye(3), [[0.1 * i], [0.0], [0.5 * i]]])
        poses.append(P.reshape(-1))
    np.savetxt(root / "poses" / "05.txt", np.stack(poses))
    return str(root)


def _same_dataset(a, b):
    """Two adapters' views of one directory: K, paths, gt, gt_T and frames."""
    np.testing.assert_array_equal(a.K, b.K)
    assert a.frame_paths == b.frame_paths and a.bootstrap_pair == b.bootstrap_pair
    for x, y in ((a.gt, b.gt), (a.gt_T, b.gt_T)):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)
    for i in (0, a.n_frames - 1):
        fa, fb = a.frame(i), b.frame(i)
        assert fa.dtype == fb.dtype == np.uint8
        np.testing.assert_array_equal(fa, fb)


# -- counterparts of tests/test_data_cli.py ---------------------------------------------

def test_kitti_adapter(kitti_root):
    ds = kitti(kitti_root)
    assert ds.n_frames == 8
    assert ds.K[0, 0] == 718.856
    assert ds.bootstrap_pair == (0, 6)
    f = ds.frame(3)
    assert f.shape == (37, 124) and f.dtype == np.uint8  # lean ingest: uint8 to the device
    gt = ds.gt_positions()
    assert gt.shape == (8, 3)
    assert np.isclose(gt[4, 2], 2.0)
    assert ds.gt_poses().shape == (8, 4, 4)
    _same_dataset(ds, jdatasets.kitti(kitti_root))


def test_kitti_adapter_reads_calib_p0(corridor_root):
    """``calib.txt``'s P0 row replaces the hard-coded K; both packages read it alike."""
    ds = load_dataset("kitti", corridor_root)
    assert ds.n_frames == 40 and ds.frame(0).shape == (96, 256)
    assert ds.K[0, 0] != 718.856 and ds.K[0, 2] == 128.0
    _same_dataset(ds, jdatasets.load_dataset("kitti", corridor_root))
    np.testing.assert_array_equal(tdatasets._pose_txt_positions(
        os.path.join(corridor_root, "kitti-dataset", "poses", "05.txt")), ds.gt)


def test_parking_adapter(tmp_path):
    root = tmp_path / "parking"
    (root / "images").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(5):
        imwrite_gray_png(str(root / "images" / f"img_{i:05d}.png"),
                         rng.uniform(0, 255, (24, 32)).astype(np.uint8))
    np.savetxt(root / "poses.txt", np.tile(np.hstack([np.eye(3), np.zeros((3, 1))]).reshape(-1), (5, 1)))
    ds = parking(str(root))
    assert ds.n_frames == 5
    assert ds.bootstrap_pair == (0, 4)
    assert ds.frame(0).shape == (24, 32)
    _same_dataset(ds, jdatasets.parking(str(root)))
    _same_dataset(load_dataset("parking", str(tmp_path)), ds)


def test_malaga_adapter(tmp_path):
    """Generated Malaga extract-07 fixture: left/right jpg stream at ~7.5 fps +
    '%'-headed GPS log at ~1 Hz with NON-UNIFORM timestamps and local x/y in cols
    8/9. GT must be associated by TIMESTAMP interpolation, not row per frame index."""
    root = tmp_path / "malaga-urban-dataset-extract-07"
    img_dir = root / "malaga-urban-dataset-extract-07_rectified_800x600_Images"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    t0 = 1261228749.0
    img_times = t0 + np.arange(6) * 0.1333  # ~7.5 fps
    for t in img_times:
        stamp = f"img_CAMERA1_{t:.6f}"
        for side in ("left", "right"):
            Image.fromarray(rng.uniform(0, 255, (30, 40)).astype(np.uint8)).save(
                img_dir / f"{stamp}_{side}.jpg"
            )
    # GPS at ~1 Hz, deliberately non-uniform, position linear in time so the
    # expected interpolation is exact: x = 2 (t - t0), y = 0.5 (t - t0)
    gps_times = t0 + np.array([-0.5, 0.35, 0.9, 2.1])
    gps = np.zeros((4, 12))
    gps[:, 0] = gps_times
    gps[:, 8] = 2.0 * (gps_times - t0)
    gps[:, 9] = 0.5 * (gps_times - t0)
    lines = ["% Time ... header line like the real sensor log"]
    lines += [" ".join(f"{v:.6f}" for v in row) for row in gps]
    (root / "malaga-urban-dataset-extract-07_all-sensors_GPS.txt").write_text("\n".join(lines))

    ds = malaga(str(root))
    assert ds.n_frames == 6                      # right images filtered out
    assert ds.K[0, 0] == 621.18428
    assert ds.bootstrap_pair == (0, 6)
    f = ds.frame(2)
    assert f.shape == (30, 40) and f.dtype == np.uint8
    gt = ds.gt_positions()
    assert gt.shape == (6, 3)
    # every frame's GT is the GPS track evaluated at the IMAGE time
    dt = img_times - t0
    assert np.allclose(gt[:, 0], 2.0 * dt, atol=1e-4)
    assert np.allclose(gt[:, 2], 0.5 * dt, atol=1e-4)
    assert ds.gt_poses() is None                 # GPS carries no rotations
    _same_dataset(ds, jdatasets.malaga(str(root)))
    assert tdatasets._malaga_image_stamp("img_CAMERA1_12.500000_left.jpg") == 12.5
    assert tdatasets._malaga_image_stamp("frame_0001.jpg") is None


def test_jpeg_frames_are_counted_as_declined(tmp_path):
    """A JPEG frame is offered to the native decoder, counted as declined, and read by
    PIL: a replay of Malaga's JPEGs shows in ``native_loader.counts()`` which decoder
    served it."""
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 256, (30, 40), dtype=np.uint8)
    path = str(tmp_path / "frame.jpg")
    Image.fromarray(arr).save(path, quality=95)
    native_loader.reset_counts()
    got = tdatasets._imread_gray(path)
    with Image.open(path) as im:
        np.testing.assert_array_equal(got, np.asarray(im.convert("L")))
    assert native_loader.counts() == {"decoded": 0, "declined": 1}


def test_prefetcher_order(kitti_root):
    ds = kitti(kitti_root)
    got = list(Prefetcher(ds, start=2, depth=2))
    assert len(got) == 6
    np.testing.assert_allclose(got[0], ds.frame(2))
    assert all(isinstance(f, np.ndarray) and f.dtype == np.uint8 for f in got)
    # transform= runs on the worker thread; close() lets a half-read stream go
    pf = Prefetcher(ds, depth=1, transform=lambda f: f.astype(np.float32) * 2.0)
    first = next(iter(pf))
    np.testing.assert_array_equal(first, ds.frame(0).astype(np.float32) * 2.0)
    pf.close()


def test_synthetic_dataset_matches_jax_package():
    a, b = SyntheticDataset(n_frames=12), jdatasets.SyntheticDataset(n_frames=12)
    np.testing.assert_array_equal(a.K, b.K)
    np.testing.assert_array_equal(a.gt, b.gt)
    np.testing.assert_array_equal(a.gt_T, b.gt_T)
    np.testing.assert_array_equal(a.frame(5), b.frame(5))
    assert load_dataset("synthetic", "unused").n_frames == 120
    with pytest.raises(ValueError, match="unknown dataset"):
        load_dataset("nowhere", "unused")


def test_cli_synthetic(tmp_path, small_yaml):
    """Per-frame mode on the synthetic dataset: the files, the full metric rows and the
    summary's keys."""
    out = cli.main(["--dataset", "synthetic", "--frames", "22", "--config", small_yaml,
                    "--out", str(tmp_path / "run"), "--device", "cpu"])
    assert out["frames"] == 16 and out["dataset"] == "synthetic"
    assert out["ate_rmse_m"] < 1.0 and out["pose_ok_rate"] > 0.9
    for k in ("wall_s", "frames_per_s", "n_rebootstraps", "metric_rows", "mean_inliers",
              "mean_tracked", "mean_reproj_rms_px", "rpe_rmse_m", "rpe_median_m",
              "rpe_trans_rmse_m", "rpe_rot_rmse_deg"):
        assert k in out, k
    assert os.path.exists(tmp_path / "run" / "trajectory.png")
    assert np.load(tmp_path / "run" / "trajectory.npz")["positions"].shape == (16, 3)
    with open(tmp_path / "run" / "metrics.jsonl") as fh:
        rows = [json.loads(l) for l in fh]
    assert len(rows) == 16 and list(rows[1]) == ["frame", "pose_ok", "tracked", "inliers",
                                                 "candidates", "promoted", "reproj_rms_px"]


def test_cli_kitti_format_end_to_end_chunked(tmp_path, corridor_root, small_yaml):
    """The product flow on a KITTI-layout dataset from the dataset tool: PNGs decoded by
    the native library on the Prefetcher thread, calib.txt intrinsics, poses file,
    chunked streaming with checkpoints, the reduced metric rows with their stamps."""
    native_loader.reset_counts()
    out = cli.main(["--dataset", "kitti", "--data-root", corridor_root, "--config", small_yaml,
                    "--chunked", "--checkpoint-every", "16", "--out", str(tmp_path / "run"),
                    "--device", "cpu"])
    assert out["frames"] == 40 - 6  # KITTI bootstrap pair [0, 6]
    assert out["ate_rmse_m"] < 0.5, out
    assert out["pose_ok_rate"] > 0.9
    assert native_loader.counts() == {"decoded": 41, "declined": 0}
    assert os.path.exists(tmp_path / "run" / "checkpoint.npz")
    with open(tmp_path / "run" / "metrics.jsonl") as fh:
        rows = [json.loads(l) for l in fh]
    assert len(rows) == 34 and list(rows[0]) == ["frame", "pose_ok", "inliers", "t"]
    # a chunk's rows are stamped together, when it completes; the next chunk's later
    assert rows[16]["t"] - rows[1]["t"] < 0.05 < rows[17]["t"] - rows[16]["t"]
    assert _tool("port_run_replay").steady_fps(str(tmp_path / "run" / "metrics.jsonl")) > 0


@pytest.mark.parametrize("chunked", [False, True], ids=["per_frame", "chunked"])
def test_cli_checkpoint_resume(tmp_path, corridor_root, small_yaml, chunked):
    """--checkpoint-every / --resume through the CLI reproduce the uninterrupted
    trajectory, exactly (the generator's state is in the checkpoint)."""
    base = ["--dataset", "kitti", "--data-root", corridor_root, "--config", small_yaml,
            "--device", "cpu", *(("--chunked",) if chunked else ())]
    out_a = cli.main([*base, "--frames", "36", "--out", str(tmp_path / "a")])
    cli.main([*base, "--frames", "24", "--checkpoint-every", "8", "--out", str(tmp_path / "b")])
    ck = tmp_path / "b" / "checkpoint.npz"
    assert ck.exists()
    saved_at = int(np.load(ck)["frame_idx_host"])
    assert 7 < saved_at <= 24
    out_c = cli.main([*base, "--frames", "36", "--resume", str(ck), "--out", str(tmp_path / "c")])
    tr_a = np.load(tmp_path / "a" / "trajectory.npz")["positions"]
    tr_c = np.load(tmp_path / "c" / "trajectory.npz")["positions"]
    assert tr_a.shape == tr_c.shape == (30, 3)
    np.testing.assert_array_equal(tr_a, tr_c)
    assert out_a["ate_rmse_m"] == out_c["ate_rmse_m"]
    # the resumed run logs only its own frames
    with open(tmp_path / "c" / "metrics.jsonl") as fh:
        assert len(fh.readlines()) == 36 - saved_at


def test_cli_flags_override_yaml_override_defaults(tmp_path, corridor_root):
    """Precedence and the two-pass load: --mode over the YAML's mode, the YAML over the
    dataclass default, the image size from the first frame, the gap from the dataset."""
    y = tmp_path / "c.yaml"
    y.write_text(SMALL_YAML + "find_new_candidates_method: shi-mask\nseed: 3\n")
    seen = {}
    from lcvo_tpu_torch import pipeline

    class Spy(pipeline.VisualOdometry):
        def __init__(self, cfg, K, device="cuda"):
            seen["cfg"], seen["device"] = cfg, device
            raise KeyboardInterrupt   # the configuration is what this test reads

    orig, pipeline.VisualOdometry = pipeline.VisualOdometry, Spy
    try:
        for extra, mode in (((), "shi-mask"), (("--mode", "sift-sift"), "sift-sift")):
            with pytest.raises(KeyboardInterrupt):
                cli.main(["--dataset", "kitti", "--data-root", corridor_root, "--config", str(y),
                          "--out", str(tmp_path / "o"), "--device", "cpu", "--ba", *extra])
            cfg = seen["cfg"]
            assert cfg.find_new_candidates_method == mode and cfg.seed == 3
            assert (cfg.image_height, cfg.image_width) == (96, 256)
            assert cfg.bootstrap.frame_gap == 6 and cfg.ba.enabled and cfg.state.max_tracks == 256
            assert seen["device"] == "cpu"
    finally:
        pipeline.VisualOdometry = orig


def test_cli_wants_cuda_without_device_flag(tmp_path, corridor_root, small_yaml):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert cli.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--dataset", "kitti", "--data-root", corridor_root, "--config", small_yaml,
                  "--out", str(tmp_path / "o")])


def test_cli_has_the_reference_flags_and_device():
    from lcvo_tpu.cli import run as jcli

    flags = lambda p: {a.option_strings[0]: (a.default, type(a).__name__) for a in p._actions}
    t, j = flags(cli.build_parser()), flags(jcli.build_parser())
    assert t.pop("--device") == ("cuda", "_StoreAction")
    assert t == j


def test_both_clis_on_one_directory(tmp_path, corridor_root, small_yaml):
    """One KITTI-layout directory through both packages' CLIs, per frame: the same
    summary keys, ``trajectory.npz`` and ``metrics.jsonl`` with the same keys, and both
    ATEs under the 0.5 m trajectory bound of tests/test_torch_pipeline.py (the two draw
    their RANSAC samples from different generators, so the trajectories are two draws,
    not copies)."""
    from lcvo_tpu.cli import run as jcli

    argv = ["--dataset", "kitti", "--data-root", corridor_root, "--config", small_yaml, "--frames", "24"]
    t = cli.main([*argv, "--out", str(tmp_path / "t"), "--device", "cpu"])
    j = jcli.main([*argv, "--out", str(tmp_path / "j")])
    assert list(t) == list(j)
    assert t["frames"] == j["frames"] == 18
    assert t["ate_rmse_m"] < 0.5 and j["ate_rmse_m"] < 0.5
    assert abs(t["ate_rmse_m"] - j["ate_rmse_m"]) < 0.5
    a, b = np.load(tmp_path / "t" / "trajectory.npz"), np.load(tmp_path / "j" / "trajectory.npz")
    assert a.files == b.files and a["positions"].shape == b["positions"].shape
    rows = [[json.loads(l) for l in open(tmp_path / d / "metrics.jsonl")] for d in ("t", "j")]
    assert [list(r) for r in rows[0]] == [list(r) for r in rows[1]]


# -- counterparts of tests/test_native_loader.py ----------------------------------------

def _roundtrip(tmp_path, arr, mode, name):
    p = str(tmp_path / name)
    Image.fromarray(arr, mode=mode).save(p)
    ours = native_loader.decode_png(p)
    with Image.open(p) as im:
        ref = np.asarray(im.convert("L"), dtype=np.float32)
    return ours, ref


def test_native_library_is_built_and_says_so():
    """With g++ and zlib installed the library builds and loads, and no error is recorded."""
    assert native_loader.available(), native_loader.build_error()
    assert native_loader.build_error() is None


def test_gray8(tmp_path):
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    ours, ref = _roundtrip(tmp_path, arr, "L", "g8.png")
    assert ours is not None
    np.testing.assert_array_equal(ours, arr.astype(np.float32))


def test_rgb8(tmp_path):
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 256, (24, 31, 3), dtype=np.uint8)
    ours, ref = _roundtrip(tmp_path, arr, "RGB", "rgb.png")
    assert ours is not None
    # both use ITU-R 601 luma; PIL rounds to uint8, we keep float — within 1 level
    assert np.abs(ours - ref).max() <= 1.0


def test_shape_probe(tmp_path):
    arr = np.zeros((10, 20), np.uint8)
    p = str(tmp_path / "s.png")
    Image.fromarray(arr).save(p)
    assert native_loader.png_shape(p) == (10, 20)
    assert native_loader.png_shape(str(tmp_path / "absent.png")) is None


def test_batch_decode(tmp_path):
    rng = np.random.default_rng(2)
    paths = []
    arrs = []
    for i in range(6):
        a = rng.integers(0, 256, (16, 18), dtype=np.uint8)
        p = str(tmp_path / f"b{i}.png")
        Image.fromarray(a).save(p)
        paths.append(p)
        arrs.append(a)
    out = native_loader.decode_batch(paths, 16, 18, n_threads=3)
    assert out is not None
    np.testing.assert_array_equal(out, np.stack(arrs).astype(np.float32))
    np.testing.assert_array_equal(out, jnative.decode_batch(paths, 16, 18, n_threads=3))


def test_unsupported_falls_back(tmp_path):
    # palette PNG -> native path declines (and counts it), dataset reader uses PIL
    arr = np.tile(np.arange(16, dtype=np.uint8), (8, 1))
    p = str(tmp_path / "pal.png")
    Image.fromarray(arr).convert("P").save(p)
    native_loader.reset_counts()
    assert native_loader.decode_png(p) is None
    assert native_loader.counts() == {"decoded": 0, "declined": 1}
    out = _imread_gray(p)
    assert out.shape == (8, 16)
    np.testing.assert_array_equal(out, jdatasets._imread_gray(p))


def test_gray8_u8_output(tmp_path):
    """uint8 decode (the lean ingest path) must match the source bytes and
    the f32 decode exactly for 8-bit gray sources."""
    rng = np.random.default_rng(7)
    arr = rng.integers(0, 256, (41, 67), dtype=np.uint8)
    p = str(tmp_path / "u8.png")
    Image.fromarray(arr, mode="L").save(p)
    ours = native_loader.decode_png(p, dtype=np.uint8)
    assert ours is not None and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, arr)
    f32 = native_loader.decode_png(p)
    np.testing.assert_array_equal(ours.astype(np.float32), f32)


def test_failed_build_is_kept_and_shown(tmp_path, monkeypatch):
    """A build that fails leaves the compiler's words in build_error(); decode_png still
    answers None per file (the caller's PIL path)."""
    monkeypatch.setattr(native_loader, "_LIB_PATH", str(tmp_path / "native" / "liblcvo_native.so"))
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_tried", False)
    monkeypatch.setattr(native_loader, "_error", None)
    (tmp_path / "native").mkdir()
    (tmp_path / "native" / "Makefile").write_text(
        "all:\n\t@echo 'png_loader.cpp:1: fatal error: zlib.h: No such file' >&2; exit 1\n")
    assert not native_loader.available()
    assert "zlib.h: No such file" in native_loader.build_error()
    p = str(tmp_path / "g.png")
    imwrite_gray_png(p, np.arange(12, dtype=np.uint8).reshape(3, 4))
    assert native_loader.decode_png(p) is None and native_loader.png_shape(p) is None
    np.testing.assert_array_equal(_imread_gray(p), np.arange(12, dtype=np.uint8).reshape(3, 4))
    # a library that is there and does not load is reported too
    monkeypatch.setattr(native_loader, "_tried", False)
    (tmp_path / "native" / "liblcvo_native.so").write_bytes(b"not a shared object")
    assert not native_loader.available() and "dlopen" in native_loader.build_error()


# -- the on-disk interfaces -------------------------------------------------------------

@pytest.mark.parametrize("shape,level", [((37, 53), 6), ((1, 1), 1), ((96, 256), 1), ((5, 1240), 0)])
def test_stdlib_png_writer_read_by_three_decoders(tmp_path, shape, level):
    rng = np.random.default_rng(sum(shape))
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    p = str(tmp_path / "w.png")
    imwrite_gray_png(p, arr, level=level)
    for dtype in (np.uint8, np.float32):
        np.testing.assert_array_equal(native_loader.decode_png(p, dtype), arr.astype(dtype))
        np.testing.assert_array_equal(jnative.decode_png(p, dtype), arr.astype(dtype))
    with Image.open(p) as im:
        assert im.mode == "L"
        np.testing.assert_array_equal(np.asarray(im), arr)
    with pytest.raises(ValueError, match="uint8"):
        imwrite_gray_png(p, arr.astype(np.float32))


def test_dataset_tool_writes_all_layouts_and_resumes(tmp_path):
    mk = _tool("port_make_replay_dataset")
    rep = mk.make_dataset("kitti-turn", frames=12, out=str(tmp_path / "turn"), device="cpu", size=(128, 64))
    assert rep["written"] == 12
    _same_dataset(load_dataset("kitti", str(tmp_path / "turn")),
                  jdatasets.load_dataset("kitti", str(tmp_path / "turn")))
    # resumable: a frame taken away is the one frame written again, byte for byte
    img = os.path.join(rep["root"], "05", "image_0", "000005.png")
    before = open(img, "rb").read()
    os.remove(img)
    again = mk.make_dataset("kitti-turn", frames=12, out=str(tmp_path / "turn"), device="cpu", size=(128, 64))
    assert again["written"] == 1 and open(img, "rb").read() == before
    assert mk.make_dataset("kitti-turn", frames=12, out=str(tmp_path / "turn"), device="cpu",
                           size=(128, 64))["written"] == 0

    rep = mk.make_dataset("parking", frames=8, out=str(tmp_path / "p"), device="cpu", size=(128, 64))
    ds = load_dataset("parking", str(tmp_path / "p"))
    assert ds.n_frames == 8 and ds.gt_T.shape == (8, 4, 4)
    _same_dataset(ds, jdatasets.load_dataset("parking", str(tmp_path / "p")))

    rep = mk.make_dataset("malaga", frames=10, out=str(tmp_path / "m"), device="cpu", size=(128, 64))
    ds = load_dataset("malaga", str(tmp_path / "m"))
    assert ds.n_frames == 10 and ds.gt.shape == (10, 3) and ds.gt_T is None
    assert ds.frame(0).shape == (64, 128)
    _same_dataset(ds, jdatasets.load_dataset("malaga", str(tmp_path / "m")))
    # GPS sampled at 1 Hz from the exact track and interpolated back to the image times
    # (the frames of the first GPS second: past the last image the log holds its position)
    exact = np.loadtxt(os.path.join(rep["root"], "exact_poses_kitti_format.txt"))[:, [3, 11]]
    np.testing.assert_allclose(ds.gt[:8, [0, 2]], exact[:8], atol=1e-3)
    with pytest.raises(ValueError, match="unknown dataset"):
        mk.make_dataset("nowhere", device="cpu")


def test_new_modules_and_tools_import_neither_jax_nor_the_jax_package():
    """In a fresh interpreter: the host-layer modules, the multi-stream and multi-process
    modules, the tools, the rank programs of the tests and chip_smoke.py."""
    code = textwrap.dedent("""
        import importlib.util, os, sys
        import lcvo_tpu_torch.cli.run, lcvo_tpu_torch.data.datasets
        import lcvo_tpu_torch.data.native_loader, lcvo_tpu_torch.data.render
        import lcvo_tpu_torch.metrics, lcvo_tpu_torch.viz, lcvo_tpu_torch.utils.profiling
        import lcvo_tpu_torch.parallel.streams, lcvo_tpu_torch.parallel.mesh
        import lcvo_tpu_torch.parallel.launch, lcvo_tpu_torch.solve.ba.sharded
        for path in ("tools/port_make_replay_dataset.py", "tools/port_run_replay.py",
                     "tools/port_probe_host.py", "tools/port_dryrun_multirank.py",
                     "tools/port_replay_seeds.py", "tests/torch_rank_programs.py",
                     "chip_smoke.py"):
            spec = importlib.util.spec_from_file_location(os.path.basename(path)[:-3], path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        bad = sorted(n for n in sys.modules
                     if n.split(".")[0] in ("jax", "jaxlib", "lcvo_tpu", "matplotlib", "PIL"))
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
