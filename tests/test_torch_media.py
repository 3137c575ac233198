"""The port's media functions (``daft_tpu_torch/functions/media.py``) and media
kernels (``daft_tpu_torch/kernels/media_ops.py``) against the JAX package's,
on the CPU.

Mirrors ``tests/test_media_functions.py``'s HDF5, video and process cases
(``test_hdf5_functions``, ``test_video_frames``, ``test_video_keyframes``,
``test_mp4_stss_parser``, ``test_run_process``, ``test_run_process_on_error``,
``test_run_process_shell_guard_and_casts``): each runs the same files, written
in ``tmp_path`` from a seed, through both packages (``device="cpu"`` for the
port) and must give the JAX package's rows and the values the JAX test
asserts. Then every field of ``video_frames``' struct, frame for frame, under
each of its options; an MJPG AVI through the ``idx1`` parser; the WAV kernels
(``audio_metadata``, ``resample``) at two rates; ``video_metadata``; the typed
constructors' ``verify`` on a wrong file; and the flat media methods of
``Expression``, which raise ``DaftIOError`` in both. Exact equality
throughout: every path decodes on the host with the same libraries.
"""

import io
import struct
import wave
import warnings

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu import functions as JF
from daft_tpu.errors import DaftIOError as JIOError
from daft_tpu.functions import media as jmedia
from daft_tpu_torch import functions as PF
from daft_tpu_torch.errors import DaftIOError
from daft_tpu_torch.functions import media as pmedia

PAIRS = ((daft_tpu, JF), (daft_tpu_torch, PF))


@pytest.fixture(autouse=True)
def _cpu():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        with daft_tpu.execution_config_ctx(result_cache_enabled=False), \
                daft_tpu_torch.execution_config_ctx(device="cpu", result_cache_enabled=False):
            yield


def _both(build):
    """``build(pkg, F)`` in the port, held equal to the JAX package's."""
    jax, port = (build(pkg, F) for pkg, F in PAIRS)
    assert port == jax
    return port


# -- hdf5 ----------------------------------------------------------------------
def test_hdf5_functions(tmp_path):
    h5py = pytest.importorskip("h5py")
    p = tmp_path / "d.h5"
    with h5py.File(p, "w") as f:
        f.create_dataset("x", data=np.arange(6).reshape(2, 3))
        f.create_dataset("z", data=np.random.default_rng(0).random((8, 4)), chunks=(4, 4),
                         compression="gzip")
        g = f.create_group("grp")
        g.attrs["note"] = "hello"
        f.attrs["version"] = 3

    def run(pkg, F):
        df = pkg.from_pydict({"p": [str(p), None]})
        fexpr = F.hdf5_file(pkg.col("p"), verify=True)
        return df.select(F.hdf5_keys(fexpr).alias("k"), F.hdf5_metadata(fexpr).alias("m"),
                         F.hdf5_attrs(fexpr).alias("a"),
                         F.hdf5_attrs(fexpr, "/grp").alias("ga")).to_pydict()

    out = _both(run)
    assert sorted(out["k"][0]) == ["grp", "x", "z"] and out["k"][1] is None
    byname = {m["h5path"]: m for m in out["m"][0]}
    assert byname["/x"]["kind"] == "dataset" and byname["/x"]["shape"] == [2, 3]
    assert byname["/z"]["chunks"] == [4, 4] and byname["/z"]["compression"] == "gzip"
    assert byname["/grp"]["kind"] == "group"
    assert out["a"][0]["version"] == 3 and out["ga"][0] == {"note": "hello"}


# -- video ---------------------------------------------------------------------
def _write_video(path, n_frames=12, w=64, h=48, fps=10, fourcc="mp4v", seed=0):
    cv2 = pytest.importorskip("cv2")
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    assert vw.isOpened()
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    for i in range(n_frames):
        vw.write(np.roll(base, 3 * i, axis=1))
    vw.release()


def _frames(path, **kwargs):
    def run(pkg, F):
        df = pkg.from_pydict({"p": [str(path), None]})
        return df.select(F.video_frames(F.video_file(pkg.col("p")), **kwargs).alias("fr")
                         ).to_pydict()["fr"]

    return _both(run)


def test_video_frames(tmp_path):
    p = tmp_path / "v.mp4"
    _write_video(p)
    rows = _frames(p)[0]
    assert len(rows) == 12
    assert rows[0]["frame_index"] == 0 and rows[0]["data"] is not None
    assert rows[1]["frame_time"] >= rows[0]["frame_time"]
    sampled = _frames(p, sample_interval_seconds=0.5)[0]
    assert 0 < len(sampled) < 12


def test_video_keyframes(tmp_path):
    p = tmp_path / "v.mp4"
    _write_video(p)
    kf = _both(lambda pkg, F: pkg.from_pydict({"p": [str(p)]}).select(
        F.video_keyframes(F.video_file(pkg.col("p"))).alias("k")).to_pydict()["k"][0])
    assert len(kf) >= 1  # at least the first sync sample


def test_mp4_stss_parser():
    stss = struct.pack(">I4sII", 16 + 8, b"stss", 0, 2) + struct.pack(">II", 1, 8)

    def box(name, payload):
        return struct.pack(">I4s", 8 + len(payload), name) + payload

    data = box(b"moov", box(b"trak", box(b"mdia", box(b"minf", box(b"stbl", stss)))))
    assert pmedia._mp4_keyframe_indices(data) == jmedia._mp4_keyframe_indices(data) == [0, 7]
    # A truncated box, a file with no stss, and an empty table.
    for bad in (data[:-3], box(b"moov", b""), box(b"moov", box(b"trak", b"xx"))):
        assert pmedia._mp4_keyframe_indices(bad) == jmedia._mp4_keyframe_indices(bad)


_FRAME_OPTIONS = {
    "whole": {},
    "resized": {"width": 32, "height": 24},
    "window": {"start_time": 0.3, "end_time": 0.8},
    "key_only": {"is_key_frame": True},
    "non_key": {"is_key_frame": False},
    "sampled": {"sample_interval_seconds": 0.25, "width": 16, "height": 16},
}


@pytest.mark.parametrize("options", list(_FRAME_OPTIONS.values()), ids=list(_FRAME_OPTIONS))
def test_every_frame_field_under_each_option(tmp_path, options):
    """Every ``_FRAME_STRUCT`` field, frame for frame, equal to the JAX
    package's; the MP4 has a sync-sample table when the codec writes one."""
    p = tmp_path / "v.mp4"
    _write_video(p, n_frames=24, seed=3)
    rows, null_row = _frames(p, **options)
    assert null_row == []
    assert all(set(r) == set(pmedia._FRAME_STRUCT.fields) for r in rows)
    w, h = options.get("width", 64), options.get("height", 48)
    keys = pmedia._keyframe_indices(p.read_bytes())
    for r in rows:
        assert (r["data"]["width"], r["data"]["height"], r["data"]["channel"]) == (w, h, 3)
        assert len(r["data"]["data"]) == w * h * 3
        assert r["is_key_frame"] == (keys is None or r["frame_index"] in keys)
        assert options.get("start_time", 0) <= r["frame_time"] <= options.get("end_time", 1e9)
    if "is_key_frame" in options and keys is not None:
        assert rows and all(r["is_key_frame"] is options["is_key_frame"] for r in rows)


def test_avi_keyframes_through_the_idx1_parser(tmp_path):
    p = tmp_path / "v.avi"
    _write_video(p, n_frames=10, fourcc="MJPG", seed=5)
    data = p.read_bytes()
    keys = pmedia._avi_keyframe_indices(data)
    assert keys == jmedia._avi_keyframe_indices(data) == pmedia._keyframe_indices(data)
    assert keys == list(range(10))  # MJPG: every frame is intra
    rows = _frames(p, is_key_frame=True)[0]
    assert [r["frame_index"] for r in rows] == keys
    kf = _both(lambda pkg, F: pkg.from_pydict({"p": [str(p)]}).select(
        F.video_keyframes(F.video_file(pkg.col("p"), verify=True)).alias("k")).to_pydict())
    assert len(kf["k"][0]) == 10


def test_video_metadata_of_the_avi(tmp_path):
    p = tmp_path / "v.avi"
    _write_video(p, n_frames=10, w=40, h=30, fps=5, fourcc="MJPG")
    out = _both(lambda pkg, F: pkg.from_pydict({"p": [str(p), None]}).select(
        F.video_metadata(pkg.col("p")).alias("m")).to_pydict())["m"]
    assert out[1] is None
    assert (out[0]["frames"], out[0]["format"]) == (10, "avi")
    assert out[0]["fps"] == pytest.approx(5.0) and out[0]["duration_sec"] == pytest.approx(2.0)
    # ROADMAP C.43, the JAX package's own reading: ``avih`` has ten u32
    # fields and the kernel unpacks nine from the first, so ``width`` is
    # dwSuggestedBufferSize and ``height`` is dwWidth.
    avih = p.read_bytes().find(b"avih")
    suggested, width = struct.unpack_from("<II", p.read_bytes(), avih + 8 + 7 * 4)
    assert (out[0]["width"], out[0]["height"]) == (suggested, width) and width == 40


# -- audio -------------------------------------------------------------------------
def _wav(rate: int, channels: int, seconds: float, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    pcm = rng.integers(-32768, 32767, (int(rate * seconds), channels), dtype=np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


@pytest.mark.parametrize("rate, channels", [(8000, 1), (22050, 2)], ids=["8k_mono", "22k_stereo"])
def test_audio_metadata_and_resample(tmp_path, rate, channels):
    raw = _wav(rate, channels, 0.5, seed=rate)
    path = tmp_path / "a.wav"
    path.write_bytes(raw)

    def run(pkg, F):
        df = pkg.from_pydict({"b": [raw, None], "p": [str(path), None]})
        return df.select(F.audio_metadata(pkg.col("b")).alias("mb"),
                         F.audio_metadata(pkg.col("p")).alias("mp"),
                         F.resample(pkg.col("b"), target_rate=16000).alias("r"),
                         F.audio_file(pkg.col("p"), verify=True).alias("f")).to_pydict()

    out = _both(lambda pkg, F: {k: v for k, v in run(pkg, F).items() if k != "f"})
    meta = out["mb"][0]
    assert out["mp"] == out["mb"] and out["mb"][1] is None and out["r"][1] is None
    assert (meta["sample_rate"], meta["channels"], meta["frames"]) == (rate, channels, rate // 2)
    assert len(out["r"][0]) == round(rate // 2 * 16000 / rate)
    # Resampling a list column at its own rate returns it unchanged.
    same = _both(lambda pkg, F: pkg.from_pydict({"s": [[0.5, -0.25, 0.0]]}).select(
        F.resample(pkg.col("s"), target_rate=rate, source_rate=rate)).to_pydict())
    assert same == {"s": [[0.5, -0.25, 0.0]]}


# -- verify and the gated flat methods --------------------------------------------
@pytest.mark.parametrize("kind", ["video", "hdf5"])
def test_verify_on_a_wrong_file_raises(tmp_path, kind):
    txt = tmp_path / "b.txt"
    txt.write_text("not a media file")
    for pkg, F in PAIRS:
        ctor = getattr(F, f"{kind}_file")
        df = pkg.from_pydict({"p": [str(txt)]})
        with pytest.raises(Exception, match=f"is not a valid {kind} file"):
            df.select(ctor(pkg.col("p"), verify=True)).collect()
        df.select(ctor(pkg.col("p"))).collect()  # without verify it passes through


@pytest.mark.parametrize("name", ["hdf5_keys", "hdf5_metadata", "hdf5_attrs", "video_frames",
                                  "video_keyframes"])
def test_flat_media_methods_raise_the_jax_packages_error(name):
    msgs = []
    for pkg, err in ((daft_tpu, JIOError), (daft_tpu_torch, DaftIOError)):
        with pytest.raises(err) as info:
            getattr(pkg.col("p"), name)()
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] and f"Expression.{name} requires the" in msgs[1]


def test_import_loads_neither_h5py_nor_cv2():
    """h5py is imported where the JAX package imports it (when an
    ``hdf5_metadata`` expression is built, or a row decodes), cv2 when a
    video decodes: neither at ``import daft_tpu_torch`` nor with the media
    modules and the top-level sources."""
    import json
    import subprocess
    import sys

    code = ("import json, sys\n"
            "import daft_tpu_torch as dt, daft_tpu_torch.functions.media\n"
            "import daft_tpu_torch.io.media_sources, daft_tpu_torch.kernels.media_ops\n"
            "dt.read_mcap, dt.read_video_frames, dt.from_files, dt.func, dt.cls\n"
            "dt.functions.video_frames(dt.col('p')), dt.functions.hdf5_keys(dt.col('p'))\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "                        ('h5py', 'cv2', 'jax', 'daft_tpu'))))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True, capture_output=True,
                         text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


# -- process ----------------------------------------------------------------------------
def test_run_process():
    out = _both(lambda pkg, F: pkg.from_pydict({"a": ["hello"], "b": ["world"]}).select(
        F.run_process(["echo", pkg.col("a"), pkg.col("b")]).alias("o"),
        F.run_process("echo hi | wc -c", shell=True,
                      return_dtype=pkg.DataType.int64()).alias("n")).to_pydict())
    assert out["o"][0].strip() == "hello world" and out["n"][0] == 3


def test_run_process_on_error():
    out = _both(lambda pkg, F: pkg.from_pydict({"x": ["a"]}).select(
        F.run_process(["false"], on_error="ignore").alias("o"),
        F.run_process(["false"], on_error="log").alias("l")).to_pydict())
    assert out == {"o": [None], "l": [None]}
    for pkg, F in PAIRS:
        with pytest.raises(Exception, match="returned non-zero exit status 1"):
            pkg.from_pydict({"x": ["a"]}).select(F.run_process(["false"], on_error="raise")
                                                 ).to_pydict()


def test_run_process_shell_guard_and_casts():
    for pkg, F in PAIRS:
        with pytest.raises(ValueError, match="shell=True"):
            F.run_process([pkg.col("x"), "y"], shell=True)

    def run(pkg, F):
        df = pkg.from_pydict({"n": ["1", "0"]})
        dt = pkg.DataType
        return (df.with_column("b", F.run_process(["echo", pkg.col("n")], return_dtype=dt.bool()))
                .with_column("i", F.run_process(["echo", pkg.col("n")], return_dtype=dt.int16()))
                .with_column("f", F.run_process(["echo", pkg.col("n")],
                                                return_dtype=dt.float32())).to_pydict(),
                pkg.from_pydict({"x": [1]}).with_column(
                    "raw", F.run_process(["printf", r"\x89PNG\xff"], return_dtype=dt.binary())
                ).to_pydict())

    out, raw = _both(run)
    assert out["b"] == [True, False] and out["i"] == [1, 0] and out["f"] == [1.0, 0.0]
    assert raw["raw"] == [b"\x89PNG\xff"]
