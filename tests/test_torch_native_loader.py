"""The port's binding of the native C++ loader (vqvae_wavenet_torch/
native_loader.py, built from cpp/dataloader.cpp into build/) against the
JAX package's (vqvae_wavenet_tpu/data/native_loader.py), and the port's
``data.make_input_pipeline`` against JAX's -loader rules
(vqvae_wavenet_tpu/data/datasets.py:318-370).  One worker thread makes
the batch order reproducible; batches are compared bit for bit."""
import os

import numpy as np
import pytest
from scipy.io import wavfile

from vqvae_wavenet_tpu.data import native_loader as jnl
from vqvae_wavenet_torch import data, native_loader as nl


@pytest.fixture(scope="module")
def built():
    if nl.build_error() is not None or not jnl.native_available():
        pytest.skip("g++ cannot build the native loader here")


def vctk_corpus(root, rate):
    """Two speakers x two utterances of 0.5 s in the VCTK layout at
    ``rate`` Hz, PCM16."""
    info = root / "vctk_info"
    info.mkdir(parents=True)
    (info / "vctk_speakers.txt").write_text("p225, 0\np226, 1\n")
    rng = np.random.default_rng(0)
    files = []
    for s in ("p225", "p226"):
        (root / "VCTK-Corpus" / "wav48" / s).mkdir(parents=True)
        for u in range(2):
            wav = (rng.uniform(-0.5, 0.5, rate // 2) * 32767).astype(np.int16)
            name = f"{s}/{s}_{u:03d}.wav"
            wavfile.write(str(root / "VCTK-Corpus" / "wav48" / name), rate,
                          wav)
            files.append(name)
    (info / "vctk_train.txt").write_text("\n".join(files) + "\n")
    return str(root)


def test_batches_equal_jax_native_loader(built, tmp_path):
    root = vctk_corpus(tmp_path, 16000)
    ds = data.VCTK(batch_size=3, max_len=1024, relative_path=root + "/")
    files = [os.path.join(root, ds.data_dir, f) for f in ds.all_files]
    ids = [ds.speaker_to_int[ds.split_func(f)] for f in ds.all_files]
    ours = nl.NativeLoader(files, ids, 2, 3, 1024, num_threads=1, seed=5)
    theirs = jnl.NativeLoader(files, ids, 2, 3, 1024, num_threads=1, seed=5)
    try:
        for _ in range(4):
            a, b = ours.next(), theirs.next()
            np.testing.assert_array_equal(a["x"], b["x"])
            np.testing.assert_array_equal(a["y"], b["y"])
            assert a["x"].shape == (3, 1024, 1) and np.abs(a["x"]).max() > 0
    finally:
        ours.stop()
        theirs.stop()
    np.testing.assert_array_equal(nl.read_wav_native(files[0]),
                                  jnl.read_wav_native(files[0]))
    assert nl.library_path().startswith(nl.BUILD_DIR)


def test_auto_picks_python_for_a_48k_corpus(built, tmp_path, capsys):
    root = vctk_corpus(tmp_path, 48000)
    pipe = data.make_input_pipeline("VCTK", batch_size=2, max_len=512,
                                    relative_path=root + "/", loader="auto",
                                    seed=0)
    try:
        assert isinstance(pipe, data.Dataset)
        assert pipe.next()["x"].shape == (2, 512, 1)
    finally:
        pipe.stop()
    out = capsys.readouterr().out
    assert "native loader ineligible (corpus is not 16 kHz PCM16" in out
    with pytest.raises(RuntimeError, match="not 16 kHz PCM16"):
        data.make_input_pipeline("VCTK", batch_size=2, max_len=512,
                                 relative_path=root + "/", loader="native")


def test_auto_picks_native_for_a_16k_corpus(built, tmp_path, capsys):
    root = vctk_corpus(tmp_path, 16000)
    pipe = data.make_input_pipeline("VCTK", batch_size=2, max_len=512,
                                    relative_path=root + "/", loader="auto",
                                    seed=0)
    try:
        assert isinstance(pipe, nl.NativeLoader)
        b = pipe.next()
        assert b["x"].shape == (2, 512, 1) and b["y"].shape == (2, 1, 2)
    finally:
        pipe.stop()
    assert "[data] native C++ loader: 4 files" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="trim_silence is python-only"):
        data.make_input_pipeline("VCTK", batch_size=2, max_len=512,
                                 relative_path=root + "/", loader="native",
                                 trim_silence=True)
    py = data.make_input_pipeline("VCTK", batch_size=2, max_len=512,
                                  relative_path=root + "/", loader="python")
    py.stop()
    assert isinstance(py, data.Dataset)
