"""Spec: 4-bit RLE image codec (nic.hpp), byte-exact -- the port's copy
of remap_tpu/spec/nic.py; tests/test_torch_core.py holds the two equal.
It is the plain version of ``io.codec``'s native codec.

Opcode layout (nic.hpp:20-45):

- ``0x80 | n``            literal run of n pixels (n < 64), packed nibble
                          pairs follow (high nibble first)
- ``0xC0 | hi, lo``       literal run of n = hi<<8 | lo pixels (n < 16384)
- ``0x00..0x3F``          ``((n-3) << 4) | color``: repeat color n times,
                          3 <= n <= 6
- ``0x40 | (b << 4) | c`` repeat color c; length in the next b (1..2)
                          little-endian bytes

Runs of >= 3 equal pixels become repeats; shorter runs stay in the literal
buffer.  The compressor state machine is transcribed from nic.hpp:8-105.
"""

from __future__ import annotations

import numpy as np


def compress(image: np.ndarray) -> bytes:
    """nic::compress (nic.hpp:8-105) over the row-major flattened image."""
    data = image.reshape(-1)
    result = bytearray()
    buffer = bytearray()

    seq_len = 1
    rep_len = 1
    current = int(data[0])
    buffer.append(current << 4)

    def write_buf(length: int) -> None:
        # the 0xC0 opcode carries a 14-bit length; longer literal runs
        # split at even pixel counts (keeps nibble-byte alignment).  The
        # reference silently corrupts the opcode here (`0xc0 | (len>>8)`
        # with len >= 16384 overflows into the opcode bits, nic.hpp:25)
        # — our split is the strictly-correct extension, byte-identical
        # on every input the reference survives.
        start = 0
        while length > 16383:
            result.append(0xC0 | (16382 >> 8))
            result.append(16382 & 0xFF)
            result.extend(buffer[start : start + 8191])
            start += 8191
            length -= 16382
        if length < 64:
            result.append(0x80 | length)
        else:
            result.append(0xC0 | (length >> 8))
            result.append(length & 0xFF)
        result.extend(buffer[start:])
        buffer.clear()

    def write_rep(length: int, color: int) -> None:
        # the 0x40|0x20 opcode carries a 16-bit length; longer repeats
        # split, leaving a >= 4 tail so the final opcode stays valid.
        # The reference CRASHES here: its uint16 rep_len wraps at 65536
        # and the next pixel pops an empty literal buffer (nic.hpp:57,
        # heap overflow under ASan — found by the e2e differential on a
        # solid flash frame).
        while length > 65535:
            result.append(0x40 | (2 << 4) | color)
            result.append(65532 & 0xFF)
            result.append(65532 >> 8)
            length -= 65532
        if length <= 6:
            result.append(((length - 3) << 4) | color)
        else:
            nbytes = 2 if length > 255 else 1
            result.append(0x40 | (nbytes << 4) | color)
            result.append(length & 0xFF)
            if nbytes == 2:
                result.append((length >> 8) & 0xFF)

    for pixel in data[1:]:
        pixel = int(pixel)
        seq_len += 1
        if current == pixel:
            rep_len += 1
            if rep_len < 3:
                if seq_len % 2 == 0:
                    buffer[-1] |= pixel
                else:
                    buffer.append(pixel << 4)
            elif rep_len == 3:
                buffer.pop()
                if seq_len % 2 == 0:
                    buffer[-1] &= 0xF0
                if buffer:
                    write_buf(seq_len - 3)
                seq_len = 3
        else:
            if rep_len > 2:
                write_rep(rep_len, current)
                seq_len = 1
                buffer.append(pixel << 4)
            else:
                if seq_len % 2 == 0:
                    buffer[-1] |= pixel
                else:
                    buffer.append(pixel << 4)
            rep_len = 1
            current = pixel

    if rep_len > 2:
        write_rep(rep_len, current)
    elif buffer:
        write_buf(seq_len)

    return bytes(result)


def decompress(pack: bytes, width: int, height: int) -> np.ndarray:
    """nic::decompress (nic.hpp:107-166).

    Valid streams decode exactly as the reference does.  MALFORMED
    streams — truncated mid-opcode, or runs writing past the frame —
    raise ValueError where the reference reads/writes out of bounds
    (its decoder trusts the stream unconditionally); real dumps may be
    damaged, and undefined behavior is not a contract worth mirroring.
    A stream that stops short of the full frame also raises: the
    reference only ever decodes packs it encoded, which are always
    exactly ``width*height`` pixels.
    """
    total = width * height
    out = np.zeros(total, dtype=np.uint8)
    pos = 0
    i = 0
    n = len(pack)
    while i < n:
        value = pack[i]
        op = value & 0xC0
        if op == 0x00:
            count = (value >> 4) + 3
            if pos + count > total:
                raise ValueError("corrupt RLE pack: repeat run past frame")
            out[pos : pos + count] = value & 0x0F
            pos += count
        elif op == 0x40:
            nbytes = (value >> 4) & 3
            if i + nbytes >= n:
                raise ValueError("truncated RLE pack: repeat length cut")
            size = 0
            for b in range(nbytes):
                i += 1
                size |= pack[i] << (8 * b)
            if pos + size > total:
                raise ValueError("corrupt RLE pack: repeat run past frame")
            out[pos : pos + size] = value & 0x0F
            pos += size
        else:
            if op == 0x80:
                pixels = value & 0x3F
            else:  # 0xC0
                if i + 1 >= n:
                    raise ValueError("truncated RLE pack: literal length cut")
                i += 1
                pixels = ((value & 0x3F) << 8) + pack[i]
            nbytes = (pixels >> 1) + (pixels & 1)
            if i + nbytes >= n:
                raise ValueError("truncated RLE pack: literal bytes cut")
            if pos + pixels > total:
                raise ValueError("corrupt RLE pack: literal run past frame")
            written = 0
            for _ in range(nbytes):
                i += 1
                pair = pack[i]
                out[pos] = pair >> 4
                pos += 1
                written += 1
                if written < pixels:
                    out[pos] = pair & 0x0F
                    pos += 1
                    written += 1
        i += 1
    if pos != total:
        raise ValueError(
            f"truncated RLE pack: decoded {pos} of {total} pixels"
        )
    return out.reshape(height, width)
