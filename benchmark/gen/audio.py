"""Seeded mono 16-bit PCM recordings for the audio CLI, written as WAV files by child processes.

A recording is pink noise (white noise through a three-pole 1/f filter)
under three steady tones and an exponential chirp, with the tones' and the chirp's frequencies drawn from the seed and
the recording's index; the length and the rate are the traffic's.  The
same (seed, index) always gives the same samples.
"""

from __future__ import annotations

import os
import time
import wave

import numpy as np

#: A 1/f (pink) filter within 0.05 dB above 10 Hz at 44.1 kHz (Kellet's three-pole fit).
PINK_B = (0.049922035, -0.095993537, 0.050612699, -0.004408786)
PINK_A = (1.0, -2.494956002, 2.017265875, -0.522189400)


def recording(seed: int, index: int, seconds: float, rate: int) -> np.ndarray:
    """The int16 samples of recording *index*."""
    rng = np.random.default_rng([seed % 2**63, 1000 + index])
    n = int(seconds * rate)
    from scipy.signal import lfilter

    x = lfilter(PINK_B, PINK_A, rng.standard_normal(n))
    x *= 0.05 / np.sqrt(np.mean(x * x))
    for f in np.exp(rng.uniform(np.log(80.0), np.log(8000.0), 3)):
        x += 0.1 * _tone(f, rng.uniform(0.0, 2.0 * np.pi), n, rate)
    f0, f1 = rng.uniform(50.0, 200.0), rng.uniform(8000.0, 16000.0)
    k = np.log(f1 / f0)
    t = np.arange(n, dtype=np.float64) / rate
    x += 0.2 * np.sin(2.0 * np.pi * f0 * seconds / k * np.expm1(k * t / seconds))
    return np.round(np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)


def _tone(freq: float, phase: float, n: int, rate: int) -> np.ndarray:
    """sin(2 pi freq t + phase) over n samples, one second's table rotated second by second."""
    seconds = -(-n // rate)
    base = 2.0 * np.pi * freq * np.arange(rate) / rate
    start = phase + 2.0 * np.pi * freq * np.arange(seconds)
    out = np.sin(start)[:, None] * np.cos(base)[None, :] + np.cos(start)[:, None] * np.sin(base)[None, :]
    return out.reshape(-1)[:n]


def write_wav(path: str, samples: np.ndarray, rate: int) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(samples.astype("<i2").tobytes())


def write_file(task: tuple) -> tuple[str, float]:
    """Child process: one recording written; (path, seconds)."""
    path, seed, index, seconds, rate = task
    t = time.perf_counter()
    write_wav(path, recording(seed, index, seconds, rate), rate)
    return path, time.perf_counter() - t


def write_recordings(root: str, seed: int, count: int, seconds: float, rate: int, workers: int) -> list[str]:
    """*count* recordings under *root*, from spawned children; their paths in index order."""
    import concurrent.futures
    import multiprocessing

    tasks = [(os.path.join(root, f"recording_{i}.wav"), seed, i, seconds, rate) for i in range(count)]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(max_workers=min(workers, count), mp_context=ctx) as pool:
        return [p for p, _ in pool.map(write_file, tasks)]
