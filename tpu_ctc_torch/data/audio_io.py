"""Raw audio file readers: RIFF/WAVE and NIST SPHERE, no external codecs.

A copy of ``tpu_ctc.data.audio_io`` (numpy only), kept here so that the
port imports nothing of the JAX package.

The reference corpus pipelines (SURVEY.md C12/C13) consumed TIMIT
(NIST-SPHERE ``.WAV``, 16 kHz 16-bit PCM) and Switchboard (SPHERE, 8 kHz
mu-law) through external Kaldi tooling.  This module makes raw corpus
trees ingestible with zero external steps: pure-Python header parsing +
``np.frombuffer`` payload decode, covering every encoding those corpora
actually use:

  * RIFF/WAVE: PCM 8/16/24/32-bit, IEEE float32/float64, mu-law (format
    tag 7), a-law (format tag 6), including WAVE_FORMAT_EXTENSIBLE.
  * NIST SPHERE: 16/8-bit linear PCM (either byte order) and mu-law,
    per the ``sample_coding`` / ``sample_byte_format`` header fields.
    Embedded-shorten SPHERE (``sample_coding: pcm,embedded-shorten``)
    is NOT supported (a lossless codec, out of scope) and raises a
    clear error.

All readers return ``(waveform float32 in [-1, 1], sample_rate)`` with
multichannel audio averaged to mono (Switchboard sides are usually split
upstream; averaging is the safe default and callers can pass
``channel=`` to pick one).  Writers for both containers exist so tests
and the bundled sample corpus can round-trip real files.
"""
from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# mu-law / a-law decode tables (ITU-T G.711)
# ---------------------------------------------------------------------------


def _mulaw_decode_table() -> np.ndarray:
    """u8 mu-law code -> float32 in [-1, 1] (G.711, bias 0x84)."""
    u = np.arange(256, dtype=np.uint8)
    u = ~u  # mu-law stores the complement
    sign = (u & 0x80) != 0
    exponent = (u >> 4) & 0x07
    mantissa = u & 0x0F
    magnitude = ((mantissa.astype(np.int32) << 3) + 0x84) << exponent
    magnitude -= 0x84
    pcm = np.where(sign, -magnitude, magnitude).astype(np.float32)
    return pcm / 32768.0


def _alaw_decode_table() -> np.ndarray:
    """u8 a-law code -> float32 in [-1, 1] (G.711, XOR 0x55)."""
    a = np.arange(256, dtype=np.uint8) ^ 0x55
    sign = (a & 0x80) != 0
    exponent = (a >> 4) & 0x07
    mantissa = (a & 0x0F).astype(np.int32)
    magnitude = np.where(exponent == 0, (mantissa << 4) + 8,
                         ((mantissa << 4) + 0x108) << (exponent - 1))
    pcm = np.where(sign, -magnitude, magnitude).astype(np.float32)
    return pcm / 32768.0


_MULAW = _mulaw_decode_table()
_ALAW = _alaw_decode_table()


def _to_mono(x: np.ndarray, n_channels: int, channel: Optional[int]) -> np.ndarray:
    if n_channels <= 1:
        return x
    x = x[: (len(x) // n_channels) * n_channels].reshape(-1, n_channels)
    if channel is not None:
        return np.ascontiguousarray(x[:, channel])
    return x.mean(axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# RIFF / WAVE
# ---------------------------------------------------------------------------

_WAVE_PCM = 1
_WAVE_FLOAT = 3
_WAVE_ALAW = 6
_WAVE_MULAW = 7
_WAVE_EXTENSIBLE = 0xFFFE


def read_wav(path: str, channel: Optional[int] = None
             ) -> Tuple[np.ndarray, int]:
    """Parse a RIFF/WAVE file -> (float32 mono waveform in [-1,1], rate)."""
    with open(path, "rb") as f:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", hdr)
            if cid == b"fmt ":
                fmt = f.read(csize)
                if len(fmt) < csize:
                    raise ValueError(f"{path}: truncated file (fmt chunk "
                                     f"declares {csize} bytes, got {len(fmt)})")
            elif cid == b"data":
                data = f.read(csize)
                if len(data) < csize:
                    raise ValueError(f"{path}: truncated file (data chunk "
                                     f"declares {csize} bytes, got {len(data)})")
            else:
                f.seek(csize + (csize & 1), os.SEEK_CUR)
                continue
            if csize & 1:  # chunks are word-aligned
                f.seek(1, os.SEEK_CUR)
            if fmt is not None and data is not None:
                break
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    (tag, n_channels, rate, _byte_rate, _block_align,
     bits) = struct.unpack("<HHIIHH", fmt[:16])
    if tag == _WAVE_EXTENSIBLE:
        # SubFormat GUID's first two bytes are the real format tag.
        if len(fmt) < 40:
            raise ValueError(f"{path}: truncated WAVE_FORMAT_EXTENSIBLE fmt")
        tag = struct.unpack("<H", fmt[24:26])[0]

    if tag == _WAVE_PCM:
        if bits == 8:
            x = (np.frombuffer(data, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(data, np.uint8)
            raw = raw[: (len(raw) // 3) * 3].reshape(-1, 3).astype(np.int32)
            v = raw[:, 0] | (raw[:, 1] << 8) | (raw[:, 2] << 16)
            v = np.where(v >= 1 << 23, v - (1 << 24), v)
            x = v.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / float(1 << 31)
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif tag == _WAVE_FLOAT:
        dt = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(data, dt).astype(np.float32)
    elif tag == _WAVE_MULAW:
        x = _MULAW[np.frombuffer(data, np.uint8)]
    elif tag == _WAVE_ALAW:
        x = _ALAW[np.frombuffer(data, np.uint8)]
    else:
        raise ValueError(f"{path}: unsupported WAVE format tag {tag}")
    return _to_mono(x, n_channels, channel), int(rate)


def write_wav(path: str, waveform: np.ndarray, sample_rate: int) -> None:
    """Write mono float32 [-1,1] as 16-bit PCM RIFF/WAVE."""
    pcm = np.clip(np.asarray(waveform, np.float32), -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    data = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(data), b"WAVE"))
        f.write(struct.pack("<4sI", b"fmt ", 16))
        f.write(struct.pack("<HHIIHH", _WAVE_PCM, 1, sample_rate,
                            sample_rate * 2, 2, 16))
        f.write(struct.pack("<4sI", b"data", len(data)))
        f.write(data)


# ---------------------------------------------------------------------------
# NIST SPHERE
# ---------------------------------------------------------------------------


def _parse_sphere_header(blob: bytes) -> dict:
    """Parse the key-value header: 'name -type value' lines."""
    fields: dict = {}
    for line in blob.decode("ascii", errors="replace").splitlines():
        parts = line.strip().split(None, 2)
        if len(parts) != 3 or parts[0] in ("end_head",):
            continue
        name, typ, value = parts
        if typ.startswith("-i"):
            try:
                fields[name] = int(value)
            except ValueError:
                pass
        elif typ.startswith("-r"):
            try:
                fields[name] = float(value)
            except ValueError:
                pass
        else:  # -sN string
            fields[name] = value
    return fields


def read_sphere(path: str, channel: Optional[int] = None
                ) -> Tuple[np.ndarray, int]:
    """Parse a NIST SPHERE file -> (float32 mono waveform in [-1,1], rate)."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if not magic.startswith(b"NIST_1A"):
            raise ValueError(f"{path}: not a NIST SPHERE file")
        try:
            header_size = int(f.read(8).strip())
        except ValueError as e:
            raise ValueError(f"{path}: bad SPHERE header size") from e
        f.seek(0)
        fields = _parse_sphere_header(f.read(header_size))
        f.seek(header_size)
        data = f.read()

    coding = str(fields.get("sample_coding", "pcm")).lower()
    n_bytes = int(fields.get("sample_n_bytes", 2))
    n_channels = int(fields.get("channel_count", 1))
    rate = int(fields.get("sample_rate", 16000))
    byte_format = str(fields.get("sample_byte_format", "01"))

    if "shorten" in coding:
        raise ValueError(
            f"{path}: embedded-shorten SPHERE is not supported; "
            "decompress with 'w_decode'/'sph2pipe -p' style tooling first")
    if coding.startswith("ulaw") or coding.startswith("mu-law") \
            or coding.startswith("mulaw"):
        x = _MULAW[np.frombuffer(data, np.uint8)]
    elif coding.startswith("alaw"):
        x = _ALAW[np.frombuffer(data, np.uint8)]
    elif coding.startswith("pcm") or coding == "":
        if n_bytes == 2:
            dt = "<i2" if byte_format == "01" else ">i2"
            x = np.frombuffer(data, dt).astype(np.float32) / 32768.0
        elif n_bytes == 1:
            x = np.frombuffer(data, np.int8).astype(np.float32) / 128.0
        else:
            raise ValueError(f"{path}: unsupported PCM sample_n_bytes {n_bytes}")
    else:
        raise ValueError(f"{path}: unsupported SPHERE sample_coding {coding!r}")

    n_samples = fields.get("sample_count")
    x = _to_mono(x, n_channels, channel)
    if isinstance(n_samples, int) and 0 < n_samples <= len(x):
        x = x[:n_samples]
    return x, rate


def write_sphere(path: str, waveform: np.ndarray, sample_rate: int,
                 coding: str = "pcm") -> None:
    """Write mono float32 [-1,1] as a NIST SPHERE file (pcm16 or ulaw)."""
    pcm = np.clip(np.asarray(waveform, np.float32), -1.0, 1.0)
    if coding == "pcm":
        payload = (pcm * 32767.0).astype("<i2").tobytes()
        n_bytes, fmt_lines = 2, ["sample_byte_format -s2 01"]
    elif coding == "ulaw":
        # Encode via nearest-neighbor against the decode table (exact for
        # values produced by the table itself; adequate for synthesis).
        order = np.argsort(_MULAW)
        idx = np.searchsorted(_MULAW[order], pcm).clip(1, 255)
        left, right = order[idx - 1], order[idx]
        pick = np.where(np.abs(_MULAW[left] - pcm) <= np.abs(_MULAW[right] - pcm),
                        left, right)
        payload = pick.astype(np.uint8).tobytes()
        n_bytes, fmt_lines = 1, []
    else:
        raise ValueError(f"unsupported coding {coding!r}")
    header_lines = [
        "NIST_1A",
        "   1024",
        "channel_count -i 1",
        f"sample_count -i {len(pcm)}",
        f"sample_rate -i {sample_rate}",
        f"sample_n_bytes -i {n_bytes}",
        f"sample_coding -s{len(coding)} {coding}",
        *fmt_lines,
        "end_head",
    ]
    header = ("\n".join(header_lines) + "\n").encode("ascii")
    with open(path, "wb") as f:
        f.write(header.ljust(1024, b" "))
        f.write(payload)


# ---------------------------------------------------------------------------
# dispatch + resampling
# ---------------------------------------------------------------------------

_NPY_MAGIC = b"\x93NUMPY"


def read_audio(path: str, target_rate: Optional[int] = None,
               channel: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Read any supported audio container by magic bytes.

    Dispatches on content (not extension): RIFF/WAVE, NIST SPHERE, or a
    raw ``.npy`` 1-D waveform (assumed already at ``target_rate``).  If
    ``target_rate`` is given and differs from the file's rate, resamples
    by windowed-sinc polyphase interpolation.
    """
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic.startswith(b"RIFF"):
        x, rate = read_wav(path, channel)
    elif magic.startswith(b"NIST_1A"):
        x, rate = read_sphere(path, channel)
    elif magic.startswith(_NPY_MAGIC):
        x = np.asarray(np.load(path), np.float32).reshape(-1)
        rate = target_rate or 16000
    else:
        raise ValueError(f"{path}: unrecognized audio container "
                         f"(magic {magic[:4]!r})")
    if target_rate is not None and rate != target_rate:
        x = resample(x, rate, target_rate)
        rate = target_rate
    return np.ascontiguousarray(x, np.float32), rate


def audio_info(path: str) -> Tuple[int, int]:
    """(sample_count, native_rate) from container headers only.

    Never reads the payload: WAV data-chunk size, SPHERE ``sample_count``
    field, or the ``.npy`` shape header — so manifest/bucketing passes
    over a 300h corpus stay metadata-speed.
    """
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic.startswith(b"RIFF"):
            f.seek(12)
            n_channels, rate, bits = 1, 16000, 16
            n = None
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                cid, csize = struct.unpack("<4sI", hdr)
                if cid == b"fmt ":
                    fmt = f.read(csize + (csize & 1))
                    if len(fmt) < 16:
                        raise ValueError(f"{path}: truncated fmt chunk")
                    (tag, n_channels, rate, _br, _ba,
                     bits) = struct.unpack("<HHIIHH", fmt[:16])
                    if tag in (_WAVE_MULAW, _WAVE_ALAW):
                        bits = 8
                elif cid == b"data":
                    n = csize // max(1, (bits // 8) * n_channels)
                    break
                else:
                    f.seek(csize + (csize & 1), os.SEEK_CUR)
            if n is None:
                raise ValueError(f"{path}: missing data chunk")
        elif magic.startswith(b"NIST_1A"):
            header_size = int(f.read(8).strip())
            f.seek(0)
            fields = _parse_sphere_header(f.read(header_size))
            rate = int(fields.get("sample_rate", 16000))
            n = fields.get("sample_count")
            if not isinstance(n, int):
                n_bytes = int(fields.get("sample_n_bytes", 2))
                ch = int(fields.get("channel_count", 1))
                size = os.path.getsize(path) - header_size
                n = size // max(1, n_bytes * ch)
        elif magic.startswith(_NPY_MAGIC):
            arr = np.load(path, mmap_mode="r")
            n, rate = int(np.prod(arr.shape)), 0  # npy carries no rate
        else:
            raise ValueError(f"{path}: unrecognized audio container")
    return int(n), int(rate)


def num_samples(path: str, target_rate: Optional[int] = None) -> int:
    """Header-only sample count, converted to ``target_rate`` if given."""
    n, rate = audio_info(path)
    if rate == 0:  # .npy waveform: assumed already at the target rate
        return n
    if target_rate is not None and rate != target_rate:
        from math import gcd
        g = gcd(rate, target_rate)
        up, down = target_rate // g, rate // g
        n = int(np.ceil(n * up / down))
    return int(n)


def resample(x: np.ndarray, rate_in: int, rate_out: int,
             num_zeros: int = 16) -> np.ndarray:
    """Windowed-sinc resampling (Hann window, ``num_zeros`` lobes).

    Handles the corpus-relevant cases (8 kHz <-> 16 kHz) with a proper
    anti-aliasing cutoff at ``min(rate_in, rate_out) / 2``.
    """
    if rate_in == rate_out or len(x) == 0:
        return np.asarray(x, np.float32)
    from math import gcd
    g = gcd(rate_in, rate_out)
    up, down = rate_out // g, rate_in // g
    cutoff = 0.5 * min(rate_in, rate_out) / rate_in  # cycles per input sample
    half_width = int(np.ceil(num_zeros / (2.0 * cutoff)))
    n_out = int(np.ceil(len(x) * up / down))
    # Output sample t_out maps to input position t_out * down / up.
    pos = np.arange(n_out, dtype=np.float64) * down / up
    base = np.floor(pos).astype(np.int64)
    frac = pos - base
    taps = np.arange(-half_width, half_width + 1, dtype=np.float64)
    # [n_out, n_taps] sinc kernel centered at the fractional position.
    t = taps[None, :] - frac[:, None]
    kernel = 2.0 * cutoff * np.sinc(2.0 * cutoff * t)
    window = 0.5 * (1.0 + np.cos(np.pi * t / half_width))
    kernel = np.where(np.abs(t) <= half_width, kernel * window, 0.0)
    xp = np.pad(x.astype(np.float64), (half_width, half_width + 1))
    idx = base[:, None] + (taps[None, :].astype(np.int64) + half_width)
    y = (xp[idx] * kernel).sum(axis=1)
    return y.astype(np.float32)
