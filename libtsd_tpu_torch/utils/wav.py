"""WAV file I/O: one-shot load/save and streaming reader/writer.

Parity: core/include/tsd/wav.hpp:17-107, core/src/wav.cc:66-537
(mono/stereo, PCM16 + float32, chunked streaming).

Copied from ``libtsd_tpu/utils/wav.py`` (host numpy; the port keeps its
own copy so that it imports nothing of the JAX package).
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

__all__ = ["wav_load", "wav_save", "WavReader", "WavWriter"]


def wav_load(path: str) -> Tuple[np.ndarray, int]:
    """Load a WAV file -> (samples float32 in [-1,1], sample_rate).
    Stereo files return shape (n, 2) (parity: wav_charge)."""
    with open(path, "rb") as f:
        header = f.read(12)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            chunk = f.read(8)
            if len(chunk) < 8:
                break
            cid, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
            payload = f.read(size + (size & 1))[:size]
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
            elif cid == b"data":
                data = payload
        if fmt is None or data is None:
            raise ValueError("missing fmt/data chunk")
        audio_fmt, nchan, rate, _, _, bits = fmt
        if audio_fmt == 3 and bits == 32:
            x = np.frombuffer(data, np.float32).astype(np.float32)
        elif audio_fmt == 1 and bits == 16:
            x = np.frombuffer(data, np.int16).astype(np.float32) / 32768.0
        elif audio_fmt == 1 and bits == 8:
            x = (np.frombuffer(data, np.uint8).astype(np.float32) - 128) / 128.0
        else:
            raise ValueError(f"unsupported WAV format {audio_fmt}/{bits}bit")
        if nchan > 1:
            x = x.reshape(-1, nchan)
        return x, rate


def wav_save(path: str, x: np.ndarray, rate: int = 44100,
             dtype: str = "int16"):
    """Save samples to WAV (parity: wav_enregistre).  x in [-1,1];
    shape (n,) mono or (n, 2) stereo."""
    x = np.asarray(x)
    nchan = 1 if x.ndim == 1 else x.shape[1]
    if dtype == "int16":
        data = np.clip(x * 32767.0, -32768, 32767).astype("<i2").tobytes()
        audio_fmt, bits = 1, 16
    elif dtype == "float32":
        data = x.astype("<f4").tobytes()
        audio_fmt, bits = 3, 32
    else:
        raise ValueError("dtype must be int16 or float32")
    byte_rate = rate * nchan * bits // 8
    block = nchan * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, audio_fmt, nchan,
                                      rate, byte_rate, block, bits))
        f.write(b"data" + struct.pack("<I", len(data)))
        f.write(data)


class WavReader:
    """Chunked streaming reader (parity: WavLecteur, wav.cc): the header
    is parsed once and each :meth:`read` freads only the requested
    frames — an hours-long capture never sits in RAM at once."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        hdr = self._f.read(12)
        if hdr[:4] != b"RIFF" or hdr[8:12] != b"WAVE":
            self._f.close()
            raise ValueError("not a RIFF/WAVE file")
        self._fmt = None
        self._data_start = self._data_len = 0
        while True:
            chunk = self._f.read(8)
            if len(chunk) < 8:
                break
            cid, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
            if cid == b"fmt ":
                self._fmt = struct.unpack("<HHIIHH", self._f.read(16))
                self._f.seek(size - 16 + (size & 1), 1)
            elif cid == b"data":
                self._data_start = self._f.tell()
                self._data_len = size
                self._f.seek(size + (size & 1), 1)
            else:
                self._f.seek(size + (size & 1), 1)
        if self._fmt is None or self._data_start == 0:
            self._f.close()
            raise ValueError("missing fmt/data chunk")
        afmt, self._nchan, self.rate, _, _, bits = self._fmt
        if (afmt, bits) == (3, 32):
            self._np_dtype, self._scale = np.float32, 1.0
        elif (afmt, bits) == (1, 16):
            self._np_dtype, self._scale = np.int16, 1.0 / 32768.0
        elif (afmt, bits) == (1, 8):
            self._np_dtype, self._scale = np.uint8, None  # offset binary
        else:
            self._f.close()
            raise ValueError(f"unsupported WAV format {afmt}/{bits}bit")
        self._frame_bytes = self._nchan * bits // 8
        self._pos = 0
        self._f.seek(self._data_start)

    @property
    def nsamples(self) -> int:
        return self._data_len // self._frame_bytes

    def read(self, n: int) -> np.ndarray:
        n = min(n, self.nsamples - self._pos)
        raw = self._f.read(n * self._frame_bytes)
        self._pos += n
        x = np.frombuffer(raw, self._np_dtype)
        if self._np_dtype == np.uint8:
            x = (x.astype(np.float32) - 128.0) / 128.0
        else:
            x = x.astype(np.float32) * self._scale
        return x.reshape(-1, self._nchan) if self._nchan > 1 else x

    @property
    def eof(self) -> bool:
        return self._pos >= self.nsamples

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class WavWriter:
    """Chunked streaming writer (parity: WavEcrivain, wav.cc): the
    header is written up front with placeholder sizes, each
    :meth:`write` appends frames directly to disk, and close() patches
    the RIFF/data sizes — memory stays bounded and a crash mid-run loses
    at most the unpatched header, not the audio."""

    def __init__(self, path: str, rate: int = 44100, dtype: str = "int16"):
        if dtype not in ("int16", "float32"):
            # same contract as wav_save: an unknown dtype used to be
            # silently treated as float32
            raise ValueError("dtype must be int16 or float32")
        self.path = path
        self.rate = rate
        self.dtype = dtype
        self._nchan = None           # fixed by the first write
        self._bytes = 0
        self._f = open(path, "wb")

    def _write_header(self):
        bits = 16 if self.dtype == "int16" else 32
        audio_fmt = 1 if self.dtype == "int16" else 3
        byte_rate = self.rate * self._nchan * bits // 8
        block = self._nchan * bits // 8
        f = self._f
        f.write(b"RIFF" + struct.pack("<I", 0) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, audio_fmt,
                                      self._nchan, self.rate, byte_rate,
                                      block, bits))
        f.write(b"data" + struct.pack("<I", 0))

    def write(self, x: np.ndarray):
        x = np.asarray(x)
        nchan = 1 if x.ndim == 1 else x.shape[1]
        if self._nchan is None:
            self._nchan = nchan
            self._write_header()
        elif nchan != self._nchan:
            raise ValueError(f"channel count changed mid-stream "
                             f"({self._nchan} -> {nchan})")
        if self.dtype == "int16":
            data = np.clip(x * 32767.0, -32768, 32767).astype(
                "<i2").tobytes()
        else:
            data = x.astype("<f4").tobytes()
        self._f.write(data)
        self._bytes += len(data)

    def close(self):
        if self._f is None:
            return
        if self._nchan is None:      # nothing written: valid empty file
            self._nchan = 1
            self._write_header()
        self._f.seek(4)
        self._f.write(struct.pack("<I", 36 + self._bytes))
        self._f.seek(40)
        self._f.write(struct.pack("<I", self._bytes))
        self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
