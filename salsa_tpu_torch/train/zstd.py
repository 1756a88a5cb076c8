"""zstd (RFC 8878) for `.orbax` checkpoints, without the `zstandard` package.

`decompress` runs the C++ decoder `csrc/zstd_decode.cpp`, built by the host C++
compiler at first use (`kernels.build.load_host_library`); a missing compiler or a
failed build raises. `decompress_plain` is the same decoder in Python, its plain
version, which only the tests run. `compress_raw` writes frames of raw blocks: a
valid zstd stream that every decoder reads, which is all the checkpoint writer
needs. Every error (a bad magic, a truncated or corrupt frame, a dictionary, a
content size or checksum that does not match) is a ValueError.
"""
from __future__ import annotations

import ctypes

MAGIC = 0xFD2FB528
BLOCK_MAX = 1 << 17  # 128 KiB

_ERRORS = {-1: "not a zstd frame (bad magic)", -2: "truncated frame", -3: "corrupt frame",
           -4: "output larger than expected", -5: "content checksum does not match",
           -6: "frame needs a dictionary", -7: "content size does not match the frame's blocks"}


class ZstdError(ValueError):
    pass


def _error(code: int, what: str = "") -> ZstdError:
    return ZstdError(f"zstd{f' ({what})' if what else ''}: {_ERRORS[code]}")


def _content_size(data: bytes) -> int | None:
    """The content size in the header of `data`'s first frame, where it has one."""
    if len(data) < 6 or int.from_bytes(data[:4], "little") != MAGIC:
        return None
    fhd = data[4]
    single, fcs_flag, did = (fhd >> 5) & 1, fhd >> 6, fhd & 3
    pos = 5 + (0 if single else 1) + (4 if did == 3 else did)
    size = (1 if single else 0) if fcs_flag == 0 else 1 << fcs_flag
    if not size or len(data) < pos + size:
        return None
    return int.from_bytes(data[pos:pos + size], "little") + (256 if size == 2 else 0)


def decompress(data: bytes, size: int | None = None, what: str = "") -> bytearray:
    """Every frame of `data` decoded by the C++ decoder, into a bytearray (which
    `np.frombuffer` maps writable, without a copy). `size` is the expected output
    size where known (a zarr chunk's); without it the buffer starts at the first
    frame's content size and grows until the frames fit. `what` names the data in
    an error."""
    from salsa_tpu_torch.kernels.build import load_host_library

    fn = load_host_library("zstd_decode").zstd_decompress
    src = bytes(data)
    # a block of at least 4 input bytes gives at most 128 KiB: no stream decodes
    # to more, whatever a corrupt header claims
    bound = (len(src) // 4 + 1) * BLOCK_MAX
    cap = size if size is not None else min(_content_size(src) or 4 * len(src), bound)
    while True:
        out = bytearray(max(cap, 1))
        n = fn(src, len(src), (ctypes.c_char * len(out)).from_buffer(out), cap)
        if n == -4 and size is None and cap < bound:
            cap = min(4 * max(cap, 1 << 16), bound)
            continue
        if n < 0:
            raise _error(n, what)
        if size is not None and n != size:
            raise ZstdError(f"zstd{f' ({what})' if what else ''}: {n} bytes, expected {size}")
        del out[n:]
        return out


def compress_raw(data: bytes) -> bytes:
    """One zstd frame of raw blocks (at most 128 KiB each) holding `data`, its
    content size in the header and no checksum."""
    data = memoryview(bytes(data))
    n = len(data)
    if n < 256:
        fhd, fcs = 0x20, n.to_bytes(1, "little")  # single segment, 1-byte size
    elif n < 65536 + 256:
        fhd, fcs = 0x60, (n - 256).to_bytes(2, "little")
    elif n < 1 << 32:
        fhd, fcs = 0xA0, n.to_bytes(4, "little")
    else:
        fhd, fcs = 0xE0, n.to_bytes(8, "little")
    out = [MAGIC.to_bytes(4, "little"), bytes([fhd]), fcs]
    for start in range(0, max(n, 1), BLOCK_MAX):
        block = data[start:start + BLOCK_MAX]
        last = start + BLOCK_MAX >= n
        out.append(((len(block) << 3) | int(last)).to_bytes(3, "little"))  # raw block
        out.append(block)
    return b"".join(out)


# ---------------------------------------------------------------------------
# the plain decoder
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _xround(acc: int, v: int) -> int:
    return (_rotl((acc + v * _P2) & _M64, 31) * _P1) & _M64


def xxh64_plain(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data` (the content checksum's hash)."""
    n, p = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64]
        while p + 32 <= n:
            for i in range(4):
                v[i] = _xround(v[i], int.from_bytes(data[p + 8 * i:p + 8 * i + 8], "little"))
            p += 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ _xround(0, x)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h = (_rotl(h ^ _xround(0, int.from_bytes(data[p:p + 8], "little")), 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h = (_rotl(h ^ (int.from_bytes(data[p:p + 4], "little") * _P1 & _M64), 23) * _P2
             + _P3) & _M64
        p += 4
    while p < n:
        h = (_rotl(h ^ (data[p] * _P5 & _M64), 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)


def _need(ok: bool, code: int = -3) -> None:
    if not ok:
        raise _error(code)


class _Back:
    """A backward bitstream: read from below the highest set bit of its last byte
    towards its first byte; bits below the first byte read as zeros."""

    def __init__(self, data: bytes):
        _need(len(data) > 0 and data[-1] != 0)
        self.data = data
        self.pos = (len(data) - 1) * 8 + data[-1].bit_length() - 1

    def peek(self, nb: int) -> int:
        if nb == 0 or self.pos <= 0:
            return 0
        lo = self.pos - nb
        if lo >= 0:
            chunk = self.data[lo >> 3:(self.pos + 7) >> 3]
            return (int.from_bytes(chunk, "little") >> (lo & 7)) & ((1 << nb) - 1)
        chunk = self.data[:(self.pos + 7) >> 3]
        return (int.from_bytes(chunk, "little") << -lo) & ((1 << nb) - 1)

    def read(self, nb: int) -> int:
        v = self.peek(nb)
        self.pos -= nb
        return v


def _fse_build(norm: list[int], log: int) -> list[tuple[int, int, int]]:
    """Normalized counts -> [(symbol, bits, base)] by state."""
    size = 1 << log
    _need(sum(1 if c == -1 else c for c in norm) == size)
    high = size - 1
    symbol = [0] * size
    nxt = [0] * len(norm)
    for s, c in enumerate(norm):
        if c == -1:
            symbol[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, c in enumerate(norm):
        for _ in range(max(c, 0)):
            symbol[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    _need(pos == 0)
    table = []
    for u in range(size):
        s = symbol[u]
        x = nxt[s]
        nxt[s] += 1
        nb = log - (x.bit_length() - 1)
        table.append((s, nb, (x << nb) - size))
    return table


def _fse_read(data: bytes, max_log: int, max_symbol: int) -> tuple[list, int, int]:
    """An FSE table description at the start of `data`: (table, log, bytes used)."""
    _need(len(data) > 0, -2)
    bitpos = 0

    def peek(nb):
        byte = bitpos >> 3
        return (int.from_bytes(data[byte:byte + 5], "little") >> (bitpos & 7)) & ((1 << nb) - 1)

    log = peek(4) + 5
    bitpos = 4
    _need(log <= max_log)
    norm: list[int] = []
    remaining, threshold, nb = (1 << log) + 1, 1 << log, log + 1
    previous0 = False
    while remaining > 1 and len(norm) <= max_symbol:
        if previous0:
            n0 = len(norm)
            while peek(2) == 3:
                n0 += 3
                bitpos += 2
            n0 += peek(2)
            bitpos += 2
            _need(n0 <= max_symbol)
            norm += [0] * (n0 - len(norm))
        mx = (2 * threshold - 1) - remaining
        v = peek(nb)
        if v & (threshold - 1) < mx:
            count = v & (threshold - 1)
            bitpos += nb - 1
        else:
            count = v & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            bitpos += nb
        count -= 1
        remaining -= abs(count)
        norm.append(count)
        previous0 = count == 0
        while remaining < threshold:
            nb -= 1
            threshold >>= 1
    _need(remaining == 1)
    used = (bitpos + 7) >> 3
    _need(used <= len(data), -2)
    return _fse_build(norm, log), log, used


def _huf_read(data: bytes) -> tuple[tuple[list[int], list[int], int], int]:
    """A Huffman tree description: ((symbol by code, bits by code, max bits), bytes used)."""
    _need(len(data) > 0, -2)
    header = data[0]
    weights: list[int] = []
    if header < 128:
        used = 1 + header
        _need(used <= len(data), -2)
        table, log, desc = _fse_read(data[1:used], 6, 255)
        _need(desc < header)
        bits = _Back(data[1 + desc:used])
        s1, s2 = bits.read(log), bits.read(log)
        states = [s1, s2]
        i = 0
        while True:
            _need(len(weights) < 255)
            sym, nb, base = table[states[i]]
            weights.append(sym)
            states[i] = base + bits.read(nb)
            if bits.pos < 0:
                _need(len(weights) < 255)
                weights.append(table[states[1 - i]][0])
                break
            i = 1 - i
    else:
        n = header - 127
        used = 1 + (n + 1) // 2
        _need(used <= len(data), -2)
        weights = [(data[1 + i // 2] >> (0 if i % 2 else 4)) & 15 for i in range(n)]
    _need(all(w <= 11 for w in weights))
    total = sum(1 << (w - 1) for w in weights if w)
    _need(total > 0)
    max_bits = total.bit_length()
    _need(max_bits <= 11)
    rest = (1 << max_bits) - total
    _need(rest & (rest - 1) == 0)
    weights.append(rest.bit_length())
    symbols, nbits = [], []
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                symbols += [s] * (1 << (w - 1))
                nbits += [max_bits + 1 - w] * (1 << (w - 1))
    _need(len(symbols) == 1 << max_bits)
    return (symbols, nbits, max_bits), used


def _huf_stream(huf, data: bytes, count: int) -> bytes:
    symbols, nbits, mb = huf
    bits = _Back(data)
    out = bytearray(count)
    for i in range(count):
        v = bits.peek(mb)
        out[i] = symbols[v]
        bits.pos -= nbits[v]
    _need(bits.pos == 0)
    return bytes(out)


_LL_BASE = [*range(16), 16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096,
            8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = [*range(3, 35), 35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
            4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_LL_NORM = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1,
            1, 1, 1, 1, -1, -1, -1, -1]
_ML_NORM = [1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7
_OF_NORM = [1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5
# (predefined norm, its log, max log, max symbol) for LL, OF, ML
_SEQ = ((_LL_NORM, 6, 9, 35), (_OF_NORM, 5, 8, 31), (_ML_NORM, 6, 9, 52))


class _Frame:
    def __init__(self):
        self.out = bytearray()
        self.rep = [1, 4, 8]
        self.huf = None
        self.tables: list = [None, None, None]  # (table, log) of LL, OF, ML


def _literals(f: _Frame, block: bytes) -> tuple[bytes, int]:
    b0 = block[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    comp = 0
    if kind < 2:
        head = (1, 2, 1, 3)[fmt]
        _need(len(block) >= head, -2)
        if head == 1:
            regen = b0 >> 3
        elif head == 2:
            regen = (b0 >> 4) + (block[1] << 4)
        else:
            regen = (b0 >> 4) + (block[1] << 4) + (block[2] << 12)
    else:
        head = 3 if fmt < 2 else fmt + 2
        _need(len(block) >= head, -2)
        c = int.from_bytes(block[:head], "little")
        width = {3: 10, 4: 14, 5: 18}[head]
        regen = (c >> 4) & ((1 << width) - 1)
        comp = (c >> (4 + width)) & ((1 << width) - 1)
    _need(regen <= BLOCK_MAX)
    p = head
    if kind == 0:
        _need(len(block) >= p + regen, -2)
        return block[p:p + regen], p + regen
    if kind == 1:
        _need(len(block) >= p + 1, -2)
        return bytes([block[p]]) * regen, p + 1
    _need(len(block) >= p + comp, -2)
    q = block[p:p + comp]
    if kind == 2:
        f.huf, t = _huf_read(q)
        q = q[t:]
    else:
        _need(f.huf is not None)  # treeless
    if fmt == 0:
        return _huf_stream(f.huf, q, regen), p + comp
    _need(len(q) >= 6, -2)
    s = [int.from_bytes(q[i:i + 2], "little") for i in (0, 2, 4)]
    _need(6 + sum(s) <= len(q))
    seg = (regen + 3) // 4
    _need(3 * seg <= regen)
    bounds = [6, 6 + s[0], 6 + s[0] + s[1], 6 + sum(s), len(q)]
    counts = [seg, seg, seg, regen - 3 * seg]
    lits = b"".join(_huf_stream(f.huf, q[bounds[i]:bounds[i + 1]], counts[i]) for i in range(4))
    return lits, p + comp


def _compressed_block(f: _Frame, block: bytes) -> None:
    _need(len(block) >= 1, -2)
    lits, p = _literals(f, block)
    _need(len(block) >= p + 1, -2)
    n_seq = block[p]
    if n_seq < 128:
        p += 1
    elif n_seq < 255:
        _need(len(block) >= p + 2, -2)
        n_seq = ((n_seq - 128) << 8) + block[p + 1]
        p += 2
    else:
        _need(len(block) >= p + 3, -2)
        n_seq = block[p + 1] + (block[p + 2] << 8) + 0x7F00
        p += 3
    if n_seq == 0:
        _need(p == len(block))
        f.out += lits
        return
    _need(len(block) >= p + 1, -2)
    modes = block[p]
    _need(modes & 3 == 0)
    p += 1
    for i, (norm, norm_log, max_log, max_symbol) in enumerate(_SEQ):
        mode = (modes >> (6 - 2 * i)) & 3
        if mode == 0:
            f.tables[i] = (_fse_build(norm, norm_log), norm_log)
        elif mode == 1:
            _need(len(block) >= p + 1, -2)
            _need(block[p] <= max_symbol)
            f.tables[i] = ([(block[p], 0, 0)], 0)
            p += 1
        elif mode == 2:
            table, log, used = _fse_read(block[p:], max_log, max_symbol)
            f.tables[i] = (table, log)
            p += used
        else:
            _need(f.tables[i] is not None)  # repeat
    bits = _Back(block[p:])
    (ll_t, ll_log), (of_t, of_log), (ml_t, ml_log) = f.tables
    ll, of, ml = bits.read(ll_log), bits.read(of_log), bits.read(ml_log)
    out, rep, lit = f.out, f.rep, 0
    for i in range(n_seq):
        of_code, ml_code, ll_code = of_t[of][0], ml_t[ml][0], ll_t[ll][0]
        _need(of_code <= 31 and ml_code <= 52 and ll_code <= 35)
        offset_value = (1 << of_code) + bits.read(of_code)
        match = _ML_BASE[ml_code] + bits.read(_ML_BITS[ml_code])
        n_lits = _LL_BASE[ll_code] + bits.read(_LL_BITS[ll_code])
        if offset_value > 3:
            offset = offset_value - 3
            rep[:] = [offset, rep[0], rep[1]]
        else:
            idx = offset_value - (0 if n_lits == 0 else 1)
            if idx == 0:
                offset = rep[0]
            elif idx == 1:
                offset = rep[1]
                rep[:] = [offset, rep[0], rep[2]]
            else:
                offset = rep[0] - 1 if idx == 3 else rep[2]
                rep[:] = [offset, rep[0], rep[1]]
        if i + 1 < n_seq:
            _, nb, base = ll_t[ll]
            ll = base + bits.read(nb)
            _, nb, base = ml_t[ml]
            ml = base + bits.read(nb)
            _, nb, base = of_t[of]
            of = base + bits.read(nb)
        _need(lit + n_lits <= len(lits))
        out += lits[lit:lit + n_lits]
        lit += n_lits
        _need(0 < offset <= len(out))
        start = len(out) - offset
        if offset >= match:
            out += out[start:start + match]
        else:  # overlapping: the match repeats its last `offset` bytes
            pattern = bytes(out[start:])
            out += (pattern * (match // offset + 1))[:match]
    _need(bits.pos == 0)
    out += lits[lit:]


def _frame(data: bytes, pos: int) -> tuple[bytes, int]:
    _need(len(data) >= pos + 5, -2)
    fhd = data[pos + 4]
    _need(fhd & 0x08 == 0)
    fcs_flag, single, checksum, did = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    pos += 5
    window = 0
    if not single:
        _need(len(data) >= pos + 1, -2)
        wd = data[pos]
        pos += 1
        base = 1 << (10 + (wd >> 3))
        window = base + (base // 8) * (wd & 7)
    did_size = 4 if did == 3 else did
    _need(len(data) >= pos + did_size, -2)
    if int.from_bytes(data[pos:pos + did_size], "little"):
        raise _error(-6)
    pos += did_size
    fcs_size = (1 if single else 0) if fcs_flag == 0 else 1 << fcs_flag
    _need(len(data) >= pos + fcs_size, -2)
    content = int.from_bytes(data[pos:pos + fcs_size], "little") + (256 if fcs_size == 2 else 0)
    pos += fcs_size
    if single:
        window = content
    block_max = min(window, BLOCK_MAX)
    f = _Frame()
    last = False
    while not last:
        _need(len(data) >= pos + 3, -2)
        bh = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = bh & 1, (bh >> 1) & 3, bh >> 3
        _need(kind != 3 and size <= block_max)
        if kind == 1:
            _need(len(data) >= pos + 1, -2)
            f.out += bytes([data[pos]]) * size
            pos += 1
            continue
        _need(len(data) >= pos + size, -2)
        if kind == 0:
            f.out += data[pos:pos + size]
        else:
            _compressed_block(f, data[pos:pos + size])
        pos += size
    if fcs_size:
        _need(len(f.out) == content, -7)
    if checksum:
        _need(len(data) >= pos + 4, -2)
        if xxh64_plain(bytes(f.out)) & 0xFFFFFFFF != int.from_bytes(data[pos:pos + 4], "little"):
            raise _error(-5)
        pos += 4
    return bytes(f.out), pos


def decompress_plain(data: bytes) -> bytes:
    """Every frame of `data` decoded in Python: the C++ decoder's plain version."""
    data = bytes(data)
    _need(len(data) >= 4, -2)
    out, pos = [], 0
    while pos < len(data):
        _need(len(data) - pos >= 4, -2)
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if magic & 0xFFFFFFF0 == 0x184D2A50:  # skippable
            _need(len(data) - pos >= 8, -2)
            size = int.from_bytes(data[pos + 4:pos + 8], "little")
            _need(len(data) - pos - 8 >= size, -2)
            pos += 8 + size
            continue
        if magic != MAGIC:
            raise _error(-1 if pos == 0 else -3)
        frame, pos = _frame(data, pos)
        out.append(frame)
    return b"".join(out)
