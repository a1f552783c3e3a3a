"""The port's native data path against the JAX package's on the CPU: the WAV
codec (``read_wav``, ``read_segment``, ``write_wav``) and the threaded batch
loader of the host library built from ``buddy_tpu_torch/csrc/`` (wavio.cpp,
loader.cpp), ``make_train_loader``'s choice, the training CLI's loader
arguments, ``DeviceLoader`` and the trainer's ``get_batch`` on its tensors.
Inputs: the in-repo WAVs and seeded files written under the test's tmp dir.
"""

import ctypes
import os
import shutil
import struct

import numpy as np
import pytest
import torch

from test_torch_common import REPO, clean_wav, torch_compose

from buddy_tpu.data import audio_io as jio
from buddy_tpu.data import loader as jloader
from buddy_tpu_torch.data import audio_io as tio
from buddy_tpu_torch.data import loader as tloader
from buddy_tpu_torch.ops import _build

HELDOUT = os.path.join(REPO, "quality_out_heldout")


def _wav_bytes(payload: bytes, fmt: int, channels: int, bits: int, sr: int = 16000,
               extensible: bool = False) -> bytes:
    """A RIFF/WAVE file around ``payload``: a LIST chunk of odd size (padded)
    before ``fmt `` (WAVE_FORMAT_EXTENSIBLE with ``fmt`` as its subformat
    when ``extensible``), then ``data``."""
    block = channels * bits // 8
    head = struct.pack("<HHIIHH", 0xFFFE if extensible else fmt, channels, sr, sr * block,
                       block, bits)
    if extensible:
        head += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", fmt) + bytes(14)
    info = b"INFOISFT\x05\x00\x00\x00test\x00"
    chunks = (b"LIST" + struct.pack("<I", len(info)) + info + b"\x00"
              + b"fmt " + struct.pack("<I", len(head)) + head
              + b"data" + struct.pack("<I", len(payload)) + payload)
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def _pcm24(x: np.ndarray) -> bytes:
    s = np.asarray(x, np.int32).reshape(-1).astype("<i4").view(np.uint8).reshape(-1, 4)
    return s[:, :3].tobytes()


@pytest.fixture(scope="module")
def formats(tmp_path_factory):
    """{name: path} of seeded files in every format the codec decodes, and
    an 8-bit one it refuses."""
    root = tmp_path_factory.mktemp("formats")
    rng = np.random.default_rng(0)
    n = 1001
    i16 = rng.integers(-2 ** 15, 2 ** 15, (n, 2)).astype("<i2")
    i24 = rng.integers(-2 ** 23, 2 ** 23, n)
    i32 = rng.integers(-2 ** 31, 2 ** 31, n).astype("<i4")
    f64 = rng.standard_normal(n).astype("<f8") * 0.3
    u8 = rng.integers(0, 256, n).astype(np.uint8)
    files = {"pcm16_stereo": _wav_bytes(i16.tobytes(), 1, 2, 16),
             "pcm24": _wav_bytes(_pcm24(i24), 1, 1, 24),
             "pcm24_extensible": _wav_bytes(_pcm24(i24), 1, 1, 24, extensible=True),
             "pcm32": _wav_bytes(i32.tobytes(), 1, 1, 32, sr=22050),
             "float64": _wav_bytes(f64.tobytes(), 3, 1, 64),
             "pcm8_refused": _wav_bytes(u8.tobytes(), 1, 1, 8)}
    out = {}
    for name, data in files.items():
        out[name] = str(root / f"{name}.wav")
        with open(out[name], "wb") as f:
            f.write(data)
    return out


@pytest.fixture(scope="module")
def noise_files(tmp_path_factory):
    """Seeded noise files (unique sample values) of 5000, 3000 and 1200
    samples: crops and wrap-pads of a 2048-sample segment."""
    root = tmp_path_factory.mktemp("noise")
    rng = np.random.default_rng(1)
    data = {}
    for i, n in enumerate((5000, 3000, 1200)):
        path = str(root / f"n{i}.wav")
        data[path] = (rng.standard_normal(n) * 0.1).astype(np.float32)
        jio.write_wav(path, data[path], 16000)
    return data


def _window_of(row: np.ndarray, files: dict):
    """(path, start) such that ``row`` is the cyclic window of that file
    starting there, or None."""
    for path, x in files.items():
        for s in np.flatnonzero(x == row[0]):
            if np.array_equal(x[(s + np.arange(len(row))) % len(x)], row):
                return path, int(s)
    return None


# ---------------------------------------------------------------------------
# the host library
# ---------------------------------------------------------------------------
def test_host_library_is_built_from_the_port_sources():
    """The library the port loads is ``_build/libhost_runtime-<hash>.so``,
    its hash over csrc/wavio.cpp, csrc/loader.cpp and the flags; it is never
    the JAX package's runtime build."""
    lib = tio.native_library()
    path = os.path.realpath(lib._name)
    assert path == os.path.realpath(_build.host_library_path())
    assert os.path.dirname(path) == os.path.realpath(_build.BUILD_DIR)
    assert os.path.basename(path).startswith("libhost_runtime-")
    assert "libbuddy_runtime" not in path
    for src in ("wavio.cpp", "loader.cpp"):
        assert os.path.exists(os.path.join(_build.CSRC_DIR, src))


def test_host_library_hash_follows_its_sources(tmp_path, monkeypatch):
    """An edited source gets another library name, so it is rebuilt."""
    before = _build.host_library_path()
    for src in _build.HOST_SOURCES:
        shutil.copy(os.path.join(_build.CSRC_DIR, src), tmp_path / src)
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    assert _build.host_library_path() == before
    with open(tmp_path / "loader.cpp", "a") as f:
        f.write("\n// edited\n")
    assert _build.host_library_path() != before


@pytest.mark.parametrize("fault", ["compile_error", "no_compiler"])
def test_host_build_failure_raises(tmp_path, monkeypatch, fault):
    """A source that does not compile raises with the compiler's output; a
    missing compiler raises naming it.  No library is left behind."""
    for src in _build.HOST_SOURCES:
        shutil.copy(os.path.join(_build.CSRC_DIR, src), tmp_path / src)
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    if fault == "compile_error":
        with open(tmp_path / "wavio.cpp", "a") as f:
            f.write("\nint broken_here(void) { return undeclared_name; }\n")
        with pytest.raises(RuntimeError, match="undeclared_name"):
            _build.build_host()
    else:
        monkeypatch.setenv("CXX", "no-such-compiler-here")
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
            _build.build_host()
    assert not os.path.exists(_build.host_library_path())


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["clean_utt0", "degraded_utt3", "bf16_full_utt5"])
def test_read_wav_in_repo_files_match_jax(name):
    path = os.path.join(HELDOUT, name + ".wav")
    got, sr = tio.read_wav(path)
    want, sr_j = jio.read_wav(path)
    assert sr == sr_j == 16000 and got.dtype == np.float32 and got.shape == (65536,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["pcm16_stereo", "pcm24", "pcm24_extensible", "pcm32",
                                  "float64", "pcm8_refused"])
def test_read_wav_formats_match_jax(formats, name):
    """PCM 16 (two channels, averaged), 24 (also as WAVE_FORMAT_EXTENSIBLE)
    and 32 bits and float64 through the codec, bit for bit with the JAX
    package's; an 8-bit file, which both codecs refuse, through scipy in
    both."""
    got, sr = tio.read_wav(formats[name])
    want, sr_j = jio.read_wav(formats[name])
    assert sr == sr_j and got.dtype == want.dtype == np.float32
    assert got.shape == (1001,)
    np.testing.assert_array_equal(got, want)
    buf = np.empty(1001, np.float32)
    refused = tio.native_library().wav_read_mono(formats[name].encode(),
                                                 buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 1001) <= 0
    assert refused == (name == "pcm8_refused")


@pytest.mark.parametrize("length", [1000, 3000, 5000], ids=["crop", "equal", "wrap"])
def test_read_segment_matches_jax(tmp_path, length):
    """A crop of a longer file, the file itself at equal length, a wrap-pad
    of a shorter one: bit for bit with the JAX package's for several seeds,
    and a cyclic window of the file."""
    x = (np.random.default_rng(2).standard_normal(3000) * 0.1).astype(np.float32)
    path = str(tmp_path / "seg.wav")
    tio.write_wav(path, x, 16000)
    starts = set()
    for seed in (0, 1, 7, 123456789, 2 ** 63 + 5):
        got = tio.read_segment(path, length, seed)
        np.testing.assert_array_equal(got, jio.read_segment(path, length, seed))
        where = _window_of(got, {path: x})
        assert where is not None
        starts.add(where[1])
    assert len(starts) == 1 if length == 3000 else len(starts) > 2
    assert tio.read_segment(str(tmp_path / "missing.wav"), length, 0) is None


def test_write_wav_bytes_match_jax(tmp_path):
    """The port's WAV files are byte for byte the JAX package's native
    writer's, and read back exactly."""
    x = clean_wav(1)[:4097] * np.float32(0.5)
    for sr in (16000, 44100):
        a, b = str(tmp_path / f"port{sr}.wav"), str(tmp_path / f"jax{sr}.wav")
        tio.write_wav(a, x[None, :], sr)
        jio.write_wav(b, x, sr)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        y, got_sr = tio.read_wav(a)
        assert got_sr == sr
        np.testing.assert_array_equal(y, x)


# ---------------------------------------------------------------------------
# the batch loader
# ---------------------------------------------------------------------------
def test_native_loader_one_worker_matches_jax(noise_files):
    """One worker: three batches bit for bit with the JAX NativeBatchLoader's
    at the same files, slots and seed."""
    files = list(noise_files)
    ours = tloader.NativeBatchLoader(files, 4, 2048, n_slots=2, n_workers=1, seed=11)
    theirs = jloader.NativeBatchLoader(files, 4, 2048, n_slots=2, n_workers=1, seed=11)
    try:
        for _ in range(3):
            got, want = ours.next_batch(), theirs.next_batch()
            assert got.shape == (4, 2048) and got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    finally:
        ours.close()
        theirs.close()


def _threads() -> set:
    return set(os.listdir("/proc/self/task"))


@pytest.mark.parametrize("n_workers", [4, 16])
def test_native_loader_workers_rows_are_windows(noise_files, n_workers):
    """Several workers (16: more than this host's share of cores, two slots
    to race for): every row of every batch is a cyclic window of one file,
    crops and wrap-pads both seen; ``close`` joins the worker threads, a
    second ``close`` is a no-op, and the closed loader stops."""
    before = _threads()
    loader = tloader.NativeBatchLoader(list(noise_files), 3, 2048, n_slots=2,
                                       n_workers=n_workers, seed=3)
    workers = _threads() - before
    assert len(workers) == n_workers
    seen = set()
    for _ in range(12):
        batch = loader.next_batch()
        assert batch.shape == (3, 2048) and batch.dtype == np.float32
        for row in batch:
            where = _window_of(row, noise_files)
            assert where is not None
            seen.add(where[0])
    assert seen == set(noise_files)
    loader.close()
    assert not workers & _threads()
    loader.close()
    with pytest.raises(StopIteration):
        loader.next_batch()
    assert list(loader) == []


def test_native_loader_refuses_bad_arguments(noise_files):
    files = list(noise_files)
    with pytest.raises(ValueError, match="at least one file"):
        tloader.NativeBatchLoader([], 2, 1024)
    for kwargs in ({"n_workers": 0}, {"n_slots": 0}):
        with pytest.raises(ValueError, match=">= 1"):
            tloader.NativeBatchLoader(files, 2, 1024, **kwargs)
    with pytest.raises(ValueError, match=">= 1"):
        tloader.NativeBatchLoader(files, 0, 1024)


def test_make_train_loader_choice(noise_files, tmp_path):
    """A VCTKTrain gets the native loader with ``num_workers``, ``prefetch``
    and ``seed``, its batches the JAX make_train_loader's; a dataset that
    only iterates segments gets the threaded loader."""
    from buddy_tpu.data.vctk import VCTKTrain as JTrain
    from buddy_tpu_torch.data.vctk import VCTKTrain
    spk = tmp_path / "p226"
    spk.mkdir()
    for i, x in enumerate(noise_files.values()):
        tio.write_wav(str(spk / f"u{i}.wav"), x, 16000)
    kw = dict(fs=16000, segment_length=2048, path=str(tmp_path), speakers_discard=[],
              speakers_test=[])
    ours = tloader.make_train_loader(VCTKTrain(**kw), 3, num_workers=1, prefetch=2, seed=9)
    theirs = jloader.make_train_loader(JTrain(**kw), 3, num_workers=1, prefetch=2, seed=9)
    try:
        assert isinstance(ours, tloader.NativeBatchLoader)
        assert isinstance(theirs, jloader.NativeBatchLoader)
        for _ in range(2):
            np.testing.assert_array_equal(ours.next_batch(), theirs.next_batch())
    finally:
        ours.close()
        theirs.close()

    class Segments:
        def __iter__(self):
            while True:
                yield np.ones(8, np.float32)

    threaded = tloader.make_train_loader(Segments(), 2, num_workers=3, seed=1)
    try:
        assert isinstance(threaded, tloader.PythonBatchLoader)
        np.testing.assert_array_equal(threaded.next_batch(), np.ones((2, 8), np.float32))
    finally:
        threaded.close()


def test_training_cli_passes_num_workers_and_seed(noise_files, tmp_path, monkeypatch):
    """The training CLI builds its loader from exp.batch_size,
    exp.num_workers and exp.seed, as the JAX package's train.py does."""
    from buddy_tpu_torch.training.__main__ import _main
    spk = tmp_path / "data" / "p226"
    spk.mkdir(parents=True)
    tio.write_wav(str(spk / "u0.wav"), next(iter(noise_files.values())), 16000)
    calls = []

    class Built(Exception):
        pass

    def record(dataset, **kwargs):
        calls.append((dataset, kwargs))
        raise Built

    monkeypatch.setattr(tloader, "make_train_loader", record)
    args = torch_compose([f"dset.train.path={tmp_path / 'data'}", "dset.train.speakers_test=[]",
                          "exp.batch_size=3", "exp.num_workers=5", "exp.seed=17",
                          f"model_dir={tmp_path / 'out'}"])
    with pytest.raises(Built):
        _main(args, device="cpu")
    (dataset, kwargs), = calls
    assert kwargs == {"batch_size": 3, "num_workers": 5, "seed": 17}
    assert dataset.train_samples == [str(spk / "u0.wav")]


# ---------------------------------------------------------------------------
# DeviceLoader and the trainer
# ---------------------------------------------------------------------------
class _Batches:
    """A loader of given host batches; StopIteration after the last."""

    def __init__(self, batches):
        self.batches, self.closed = list(batches), False

    def next_batch(self):
        if not self.batches:
            raise StopIteration
        return self.batches.pop(0)

    def close(self):
        self.closed = True


def test_device_loader_on_the_cpu_keeps_order(noise_files):
    """On the CPU, DeviceLoader yields the loader's batches in order as
    float32 tensors, one fetched ahead, stops after the last and closes
    the loader; over the native loader, the same batches as a second
    native loader at the same seed."""
    want = [np.full((2, 5), i, np.float32) for i in range(4)]
    loader = _Batches([w.copy() for w in want])
    dl = tloader.DeviceLoader(loader, device="cpu")
    assert len(loader.batches) == 3             # one batch ahead
    got = list(dl)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(StopIteration):
        dl.next_batch()
    dl.close()
    assert loader.closed

    files = list(noise_files)
    a = tloader.NativeBatchLoader(files, 2, 1024, n_workers=1, seed=4)
    b = tloader.NativeBatchLoader(files, 2, 1024, n_workers=1, seed=4)
    dl = tloader.DeviceLoader(a, device="cpu")
    try:
        for _ in range(3):
            np.testing.assert_array_equal(next(dl).numpy(), b.next_batch())
    finally:
        dl.close()
        b.close()


def test_device_loader_gives_the_ranks_rows():
    """With a dp=2 sharding, each rank's DeviceLoader holds its half of the
    rows of each global batch, as ``shard_batch`` cuts it."""
    from buddy_tpu_torch.parallel import mesh as pmesh
    glob = [np.arange(24, dtype=np.float32).reshape(4, 6) + 100 * i for i in range(2)]
    for rank in (0, 1):
        mesh = pmesh.Mesh(np.arange(2), ("dp",), rank, make_groups=False)
        dl = tloader.DeviceLoader(_Batches([g.copy() for g in glob]), device="cpu",
                                  sharding=pmesh.batch_sharding(mesh))
        for g in glob:
            np.testing.assert_array_equal(dl.next_batch().numpy(), g[2 * rank:2 * rank + 2])


def test_trainer_get_batch_takes_a_device_tensor(tmp_path):
    """``get_batch`` uses a tensor already on its device as it is (no host
    round trip) and turns a host array into the same values."""
    from test_torch_common import jax_tiny_bundle, torch_trainer
    _, tree = jax_tiny_bundle(4096, seed=3)
    x = np.stack([clean_wav(0)[:4096], clean_wav(1)[:4096]])
    tr = torch_trainer(tree, x, str(tmp_path))
    on_device = torch.from_numpy(x.copy())
    tr.dset = _Batches([on_device, x])
    got = tr.get_batch()
    assert got.data_ptr() == on_device.data_ptr()
    np.testing.assert_array_equal(tr.get_batch().numpy(), x)
