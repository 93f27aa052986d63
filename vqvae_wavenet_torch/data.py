"""Host-side audio and speaker-table readers for generation (the port's
copy of vqvae_wavenet_tpu/data/datasets.py:37-48, 106-123, so the port
never imports the JAX package)."""
from __future__ import annotations

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
