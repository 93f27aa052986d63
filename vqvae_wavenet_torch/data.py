"""Host-side data for the port (its own copy of
vqvae_wavenet_tpu/data/datasets.py:37-283, so the port never imports the
JAX package): speaker tables, wav reading at 16 kHz, and the training
sampler -- manifests found under the data root or its <corpus>_info/
folder, a uniformly drawn file, a random ``max_len`` crop (short files are
zero-padded), the speaker one-hot, prefetched by one background thread.
Randomness comes from an explicit numpy seed.  ``make_input_pipeline``
picks this python loader or the native C++ one (native_loader.py) as the
JAX package's -loader flag does; ``get_speaker_info`` reads the speakers'
metadata for visualise.py.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Optional

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def get_speaker_to_int(speaker_path: str) -> dict:
    """Parse 'speaker, int' lines (reference utils.py:93-100)."""
    speaker_to_int = {}
    with open(speaker_path) as f:
        for line in f:
            line = line.strip()
            if line:
                speaker, number = line.split(", ")
                speaker_to_int[speaker] = int(number)
    return speaker_to_int


def get_speaker_info(speaker_to_int: dict, info_path: str) -> dict:
    """Speaker gender/accent metadata for the projector (utils.py:103-116);
    VCTK is detected by the absence of '|' in the header line."""
    with open(info_path) as f:
        lines = f.readlines()
    speaker_info = {}
    is_vctk = "|" not in lines[0]
    for line in lines[1:]:
        parts = line.split(maxsplit=1)
        if len(parts) < 2:
            continue
        speaker, info = parts
        speaker = ("p" if is_vctk else "") + speaker
        if speaker in speaker_to_int:
            speaker_info[speaker_to_int[speaker]] = "#".join(info.split())
    for v in speaker_to_int.values():
        speaker_info.setdefault(v, "missing_info")
    return speaker_info


def read_wav_16k(path: str) -> np.ndarray:
    """Read a wav as float32 at 16 kHz with the reference's int16
    normalization (dataset.py:41)."""
    sr, wav = wavfile.read(path)
    wav = np.asarray(wav)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    if wav.dtype == np.int16:
        wav = (wav.astype(np.float32) + 0.5) / 32767.5
    elif wav.dtype == np.int32:
        wav = (wav.astype(np.float32) + 0.5) / 2147483647.5
    else:
        wav = wav.astype(np.float32)
    if sr != 16000:
        g = np.gcd(int(sr), 16000)
        wav = resample_poly(wav, 16000 // g, sr // g).astype(np.float32)
    return wav


def trim_silence(audio: np.ndarray, threshold: float = 0.01,
                 frame_length: int = 2048) -> np.ndarray:
    """Remove leading/trailing silence by frame RMS energy (dataset.py:
    23-31, in numpy).  Returns empty audio if all silent."""
    audio = np.asarray(audio)
    if audio.size < frame_length:
        frame_length = max(int(audio.size), 1)
    hop = frame_length // 4 or 1
    n_frames = 1 + max(audio.size - frame_length, 0) // hop
    rms = np.asarray([
        np.sqrt(np.mean(audio[i * hop:i * hop + frame_length] ** 2))
        for i in range(n_frames)])
    frames = np.nonzero(rms > threshold)[0]
    if frames.size == 0:
        return audio[0:0]
    start = frames[0] * hop
    end = min(frames[-1] * hop + frame_length, audio.size)
    return audio[start:end]


class Dataset:
    """Infinite uniform-file random-crop sampler (dataset.py:33-63)."""

    filename: str
    speaker_file: str
    data_dir: str
    split_func: Callable[[str], str]
    info_locations: tuple = ()
    exclude_file: Optional[str] = None

    def __init__(self, batch_size: int = 1, max_len: int = 5120,
                 relative_path: str = "data/", seed: Optional[int] = None,
                 prefetch: int = 4, trim_silence: bool = False):
        self.batch_size = batch_size
        self.max_len = max_len
        self.relative_path = relative_path
        self._rng = np.random.default_rng(seed)
        self._prefetch = prefetch
        self.trim = trim_silence
        self.speaker_to_int = get_speaker_to_int(self._find(self.speaker_file))
        self.num_speakers = len(self.speaker_to_int)
        with open(self._find(self.filename)) as f:
            self.all_files = [line.strip() for line in f if line.strip()]
        if self.exclude_file is not None:
            try:
                with open(self._find(self.exclude_file)) as f:
                    excluded = {line.strip() for line in f if line.strip()}
                self.all_files = [p for p in self.all_files
                                  if p not in excluded]
            except FileNotFoundError:
                pass
        self._rng.shuffle(self.all_files)
        self._queue = None

    def _find(self, name: str) -> str:
        for sub in ("",) + self.info_locations:
            candidate = os.path.join(self.relative_path, sub, name)
            if os.path.exists(candidate):
                return candidate
        raise FileNotFoundError(
            f"{name} not found under {self.relative_path} "
            f"(searched {('.',) + self.info_locations})")

    def _element(self):
        filename = self.all_files[self._rng.integers(len(self.all_files))]
        wav = read_wav_16k(os.path.join(self.relative_path, self.data_dir,
                                        filename))
        if self.trim:
            wav = trim_silence(wav)
        if len(wav) <= self.max_len:
            wav = np.pad(wav, (0, self.max_len + 1 - len(wav)))
        start = self._rng.integers(0, len(wav) - self.max_len)
        crop = wav[start:start + self.max_len].reshape(self.max_len, 1)
        return (crop.astype(np.float32),
                self.speaker_to_int[self.split_func(filename)])

    def batch(self):
        """One host batch: x [B, max_len, 1] float32, y one-hot [B, 1, S]."""
        xs, ys = [], []
        for _ in range(self.batch_size):
            x, s = self._element()
            xs.append(x)
            ys.append(s)
        y = np.zeros((self.batch_size, 1, self.num_speakers), np.float32)
        y[np.arange(self.batch_size), 0, ys] = 1.0
        return {"x": np.stack(xs), "y": y}

    def start(self):
        """Start the prefetch thread (batches are then read by next())."""
        if self._queue is not None:
            return self
        self._queue = queue.Queue(maxsize=self._prefetch)
        self._stop = threading.Event()
        self._worker_error = None

        def worker():
            while not self._stop.is_set():
                try:
                    item = self.batch()
                except Exception as e:      # surface in next(), don't hang
                    self._worker_error = e
                    return
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        return self

    def next(self):
        if self._queue is None:
            return self.batch()
        while True:
            try:
                return self._queue.get(timeout=1.0)
            except queue.Empty:
                if self._worker_error is not None:
                    raise RuntimeError("dataset prefetch worker failed"
                                       ) from self._worker_error

    def stop(self):
        if self._queue is not None:
            self._stop.set()
            self._thread.join(timeout=2)
            self._queue = None


class LibriSpeech(Dataset):
    filename = "librispeech_train_clean_100.txt"
    speaker_file = "librispeech_speakers.txt"
    data_dir = ""
    split_func = staticmethod(lambda s: s.split("/")[-1].split("-", 1)[0])
    info_locations = ("librispeech_info",)


class VCTK(Dataset):
    filename = "vctk_train.txt"
    speaker_file = "vctk_speakers.txt"
    data_dir = "VCTK-Corpus/wav48/"
    split_func = staticmethod(lambda s: s.split("/")[0])
    info_locations = ("vctk_info",)
    exclude_file = "vctk_too_short.txt"


class Aishell(Dataset):
    """Aishell (dataset.py:136-144); its manifest is not shipped."""
    filename = "aishell_train.txt"
    speaker_file = "aishell_speakers.txt"
    data_dir = ""
    split_func = staticmethod(lambda s: s.split("/train/")[1].split("/")[0])
    info_locations = ("aishell_info",)


DATASETS = {"VCTK": VCTK, "LibriSpeech": LibriSpeech, "Aishell": Aishell}


def wav_is_pcm16_16k(path: str) -> bool:
    """Header-only probe: RIFF/WAVE, PCM (format 1), 16-bit, 16 kHz, what
    the native loader reads (it parses PCM16 and does not resample)."""
    try:
        with open(path, "rb") as f:
            if f.read(4) != b"RIFF":
                return False
            f.read(4)
            if f.read(4) != b"WAVE":
                return False
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    return False
                size = int.from_bytes(hdr[4:8], "little")
                if hdr[:4] == b"fmt ":
                    fmt = f.read(min(size, 16))
                    if len(fmt) < 16:
                        return False
                    return (int.from_bytes(fmt[0:2], "little") == 1
                            and int.from_bytes(fmt[14:16], "little") == 16
                            and int.from_bytes(fmt[4:8], "little") == 16000)
                f.seek((size + 1) & ~1, 1)
    except OSError:
        return False


def make_input_pipeline(name: str, *, batch_size: int, max_len: int,
                        relative_path: str = "data/", loader: str = "auto",
                        seed: Optional[int] = None,
                        trim_silence: bool = False):
    """The started training input pipeline (datasets.py:318-370):
    'python' the Dataset above; 'native' the C++ loader (4 worker
    threads), which raises with the reason when the corpus is not 16 kHz
    PCM16, with trim_silence, or when the library does not build; 'auto'
    the native loader when it is eligible, else python (printing why).
    Both expose next() -> {'x', 'y'}, stop() and num_speakers."""
    if name not in DATASETS:
        raise NotImplementedError(f"dataset {name} not implemented")
    if loader not in ("auto", "python", "native"):
        raise ValueError(f"unknown loader '{loader}'")
    ds = DATASETS[name](batch_size=batch_size, max_len=max_len,
                        relative_path=relative_path, seed=seed,
                        trim_silence=trim_silence)
    if loader == "python":
        return ds.start()
    from vqvae_wavenet_torch import native_loader as nl
    probe = os.path.join(relative_path, ds.data_dir, ds.all_files[0])
    reason = None
    if trim_silence:
        reason = "trim_silence is python-only"
    elif not wav_is_pcm16_16k(probe):
        reason = f"corpus is not 16 kHz PCM16 ({probe})"
    else:
        err = nl.build_error()
        if err is not None:
            reason = f"native library failed to build ({err})"
    if reason is None:
        files = [os.path.join(relative_path, ds.data_dir, f)
                 for f in ds.all_files]
        ids = [ds.speaker_to_int[ds.split_func(f)] for f in ds.all_files]
        pipe = nl.NativeLoader(files, ids, ds.num_speakers, batch_size,
                               max_len, seed=seed if seed is not None else 0)
        print(f"[data] native C++ loader: {len(files)} files, "
              f"{pipe.num_threads} worker threads")
        return pipe
    if loader == "native":
        raise RuntimeError(f"-loader native unavailable: {reason}")
    print(f"[data] native loader ineligible ({reason}); using the python "
          f"pipeline")
    return ds.start()
