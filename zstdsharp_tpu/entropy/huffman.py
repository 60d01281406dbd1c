"""Huffman literals codec (reference: Unsafe/HufCompress.cs, HufDecompress.cs,
EntropyCommon.cs:292).

Decode: weight parsing (HUF_readStats), X1 single-symbol table
(HUF_readDTableX1), 1-stream and 4-stream decoders.  The X2 double-symbol
decoder is a pure speed variant of the same format; the batched device
decoder lives in ops/device_huf.py.

Encode: tree build (two-queue merge over count-sorted symbols, height-limited
to <= 12 bits like HUF_setMaxHeight), weight serialization (FSE-compressed or
raw nibbles, HUF_writeCTable_wksp), and vectorized 1X/4X bitstream emission
via the prefix-scan packer (the encode hot loop HUF_compress1X_...:1056 maps
to bitstream.pack_bits: symbols are consumed back-to-front).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import HUF_SYMBOLVALUE_MAX, HUF_TABLELOG_ABSOLUTEMAX, HUF_TABLELOG_DEFAULT
from ..errors import ZstdError, ZstdErrorCode, check
from . import fse
from .bitstream import BitReader, pack_bits

# ---------------------------------------------------------------------------
# Weights (shared by encode/decode)
# ---------------------------------------------------------------------------


def read_weights(src: bytes) -> tuple[np.ndarray, int, int]:
    """HUF_readStats_body (EntropyCommon.cs:292).

    Parses the weight header, reconstructs the implied last weight, and
    returns (weights[nbSymbols], table_log, bytes_consumed).
    """
    check(len(src) >= 1, ZstdErrorCode.srcSize_wrong)
    i_size = src[0]
    if i_size >= 128:
        # Raw 4-bit weights, first symbol in the high nibble.
        o_size = i_size - 127
        consumed = ((o_size + 1) // 2) + 1
        check(len(src) >= consumed, ZstdErrorCode.srcSize_wrong)
        nib = np.frombuffer(src[1:consumed], dtype=np.uint8)
        weights = np.empty(o_size, dtype=np.uint8)
        weights[0::2] = nib >> 4
        weights[1::2] = (nib & 15)[: o_size // 2]
    else:
        consumed = i_size + 1
        check(len(src) >= consumed, ZstdErrorCode.srcSize_wrong)
        payload = src[1:consumed]
        norm, max_sym, tlog, hdr = fse.read_ncount(payload, max_symbol_limit=12, max_table_log=6)
        dtable = fse.build_dtable(norm, max_sym, tlog)
        raw = fse.fse_decompress(payload[hdr:], dtable, max_dst=HUF_SYMBOLVALUE_MAX + 1)
        weights = np.frombuffer(raw, dtype=np.uint8).copy()
        o_size = len(weights)
    check(o_size >= 1, ZstdErrorCode.corruption_detected)
    check(int(weights.max(initial=0)) <= HUF_TABLELOG_ABSOLUTEMAX,
          ZstdErrorCode.corruption_detected, "weight too large")

    # Reconstruct the implied last weight (EntropyCommon.cs:292 tail).
    total = int(np.sum((weights > 0) * (np.uint32(1) << np.maximum(weights.astype(np.uint32), 1) >> 1)))
    check(total != 0, ZstdErrorCode.corruption_detected)
    table_log = fse.highbit32(total) + 1
    check(table_log <= HUF_TABLELOG_ABSOLUTEMAX, ZstdErrorCode.corruption_detected)
    rest = (1 << table_log) - total
    verif = 1 << fse.highbit32(rest)
    check(verif == rest, ZstdErrorCode.corruption_detected, "weights don't sum to power of 2")
    last_weight = fse.highbit32(rest) + 1
    weights = np.append(weights, np.uint8(last_weight))
    return weights, table_log, consumed


# ---------------------------------------------------------------------------
# Decode (X1)
# ---------------------------------------------------------------------------


@dataclass
class HufDTable:
    table_log: int
    symbol: np.ndarray  # uint8 [1 << table_log]
    nb_bits: np.ndarray  # uint8 [1 << table_log]


def build_dtable(weights: np.ndarray, table_log: int) -> HufDTable:
    """HUF_readDTableX1 canonical fill: symbols in natural order, grouped by
    weight rank, each spanning 1 << (w-1) consecutive cells."""
    size = 1 << table_log
    symbol = np.zeros(size, dtype=np.uint8)
    nb_bits = np.zeros(size, dtype=np.uint8)
    rank_start = np.zeros(HUF_TABLELOG_ABSOLUTEMAX + 2, dtype=np.int64)
    for w in range(1, table_log + 1):
        rank_start[w + 1] = rank_start[w] + int(np.sum(weights == w)) * (1 << (w - 1))
    check(rank_start[table_log + 1] == size, ZstdErrorCode.corruption_detected)
    fill = rank_start.copy()
    for s, w in enumerate(weights):
        w = int(w)
        if w == 0:
            continue
        length = 1 << (w - 1)
        pos = fill[w]
        symbol[pos : pos + length] = s
        nb_bits[pos : pos + length] = table_log + 1 - w
        fill[w] += length
    return HufDTable(table_log, symbol, nb_bits)


def decode_stream(reader: BitReader, dt: HufDTable, n_out: int) -> np.ndarray:
    """Decode one Huffman stream of n_out symbols (HUF_decodeStreamX1:264)."""
    tlog = dt.table_log
    if n_out > 64:
        from .. import native

        if native.get_lib() is not None and reader.pos == reader.nbits_total:
            payload = bytes(reader._buf[BitReader._PAD:])
            out = native.huf_decode_stream(payload, dt.symbol, dt.nb_bits,
                                           tlog, n_out)
            if out is not None:
                reader.pos = 0
                return out
            raise ZstdError(ZstdErrorCode.corruption_detected,
                            "huffman stream overrun")
    sym = dt.symbol.tolist()
    nbb = dt.nb_bits.tolist()
    out = np.empty(n_out, dtype=np.uint8)
    # Local-variable fast loop over the reader internals.
    buf = reader._buf
    pos = reader.pos + BitReader._PAD * 8
    mask = (1 << tlog) - 1
    for i in range(n_out):
        p = pos - tlog
        byte = p >> 3
        window = int.from_bytes(buf[byte : byte + 8], "little")
        idx = (window >> (p & 7)) & mask
        out[i] = sym[idx]
        pos -= nbb[idx]
    reader.pos = pos - BitReader._PAD * 8
    if reader.pos < 0:
        raise ZstdError(ZstdErrorCode.corruption_detected, "huffman stream overrun")
    return out


def decode_1x(src: bytes, dt: HufDTable, dst_size: int) -> np.ndarray:
    reader = BitReader(src)
    out = decode_stream(reader, dt, dst_size)
    check(reader.finished, ZstdErrorCode.corruption_detected, "1X not fully consumed")
    return out


def decode_4x(src: bytes, dt: HufDTable, dst_size: int) -> np.ndarray:
    """4-stream decode (HUF_decompress4X1...:342): 6-byte jump table then
    four independent backward streams, segments of ceil(dst/4)."""
    check(len(src) >= 10, ZstdErrorCode.corruption_detected, "4X too small")
    l1, l2, l3 = (int(v) for v in np.frombuffer(src[:6], dtype="<u2"))
    starts = [6, 6 + l1, 6 + l1 + l2, 6 + l1 + l2 + l3]
    check(starts[3] <= len(src), ZstdErrorCode.corruption_detected)
    seg = (dst_size + 3) // 4
    sizes = [seg, seg, seg, dst_size - 3 * seg]
    check(sizes[3] >= 0, ZstdErrorCode.corruption_detected)
    bounds = starts + [len(src)]
    out = np.empty(dst_size, dtype=np.uint8)
    o = 0
    for k in range(4):
        payload = src[bounds[k] : bounds[k + 1]]
        reader = BitReader(payload)
        out[o : o + sizes[k]] = decode_stream(reader, dt, sizes[k])
        check(reader.finished, ZstdErrorCode.corruption_detected, f"4X stream {k}")
        o += sizes[k]
    return out


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


@dataclass
class HufCTable:
    table_log: int
    max_symbol: int
    nb_bits: np.ndarray  # uint8 [max_symbol+1], 0 = absent
    code: np.ndarray  # uint16 [max_symbol+1]


def _huffman_lengths(counts: np.ndarray) -> np.ndarray:
    """Optimal prefix-code lengths via two-queue merge over sorted leaves.

    Symbols sorted by (count desc, symbol desc) matching HUF_sort's bucket
    order closely enough for ratio parity; exact tie-breaking parity with
    HUF_sort:635 is tracked in PARITY.md.
    """
    syms = np.nonzero(counts)[0]
    n = len(syms)
    assert n >= 2
    order = np.lexsort((-syms, counts[syms]))  # ascending count
    leaf_counts = counts[syms][order].astype(np.int64)

    # Two-queue optimal merge: leaves queue + internal-nodes queue.
    parent = np.full(2 * n - 1, -1, dtype=np.int64)
    weight = np.zeros(2 * n - 1, dtype=np.int64)
    weight[:n] = leaf_counts
    li, ii = 0, n  # next leaf, next internal
    next_node = n
    for _ in range(n - 1):
        picks = []
        for _ in range(2):
            if li < n and (ii >= next_node or weight[li] <= weight[ii]):
                picks.append(li); li += 1
            else:
                picks.append(ii); ii += 1
        weight[next_node] = weight[picks[0]] + weight[picks[1]]
        parent[picks[0]] = next_node
        parent[picks[1]] = next_node
        next_node += 1
    depth = np.zeros(2 * n - 1, dtype=np.int64)
    for node in range(2 * n - 3, -1, -1):
        depth[node] = depth[parent[node]] + 1
    lengths = np.zeros(len(counts), dtype=np.int64)
    lengths[syms[order]] = depth[:n]
    return lengths


def _limit_lengths(lengths: np.ndarray, counts: np.ndarray, max_bits: int) -> np.ndarray:
    """Height-limit code lengths preserving Kraft equality (HUF_setMaxHeight
    behavioral equivalent: truncate then repay debt from cheapest ranks)."""
    lengths = lengths.copy()
    over = lengths > max_bits
    if not over.any():
        return lengths
    # Kraft budget in units of 2^-max_bits.
    debt = int(np.sum((1 << (max_bits - np.minimum(lengths[lengths > 0], max_bits))) )) - (1 << max_bits)
    lengths[over] = max_bits
    debt = int(np.sum(1 << (max_bits - lengths[lengths > 0]))) - (1 << max_bits)
    # Repay: demote (lengthen is impossible at max) -> promote cheaper symbols
    # by increasing shorter codes' lengths... classic approach: repeatedly take
    # a symbol with the smallest count whose length < max_bits and increase it.
    while debt > 0:
        # increasing a symbol's length from L to L+1 frees 2^(max-L-1) units
        cands = np.nonzero((lengths > 0) & (lengths < max_bits))[0]
        assert len(cands) > 0
        # choose the candidate with the longest current length (cheapest gain)
        # whose gain does not overshoot; prefer lowest count
        gains = 1 << (max_bits - lengths[cands] - 1)
        ok = cands[gains <= debt] if (gains <= debt).any() else cands
        gains_ok = 1 << (max_bits - lengths[ok] - 1)
        best = ok[np.lexsort((counts[ok], -lengths[ok]))][0]
        lengths[best] += 1
        debt -= 1 << (max_bits - lengths[best])
    while debt < 0:
        # give back: shorten the most frequent symbol whose shortening fits
        cands = np.nonzero(lengths > 1)[0]
        gains = 1 << (max_bits - lengths[cands])  # cost of shortening by 1
        ok = cands[gains <= -debt]
        assert len(ok) > 0
        best = ok[np.argmax(counts[ok])]
        lengths[best] -= 1
        debt += 1 << (max_bits - lengths[best] - 1)
    assert int(np.sum(1 << (max_bits - lengths[lengths > 0]))) == (1 << max_bits)
    return lengths


def build_ctable(counts: np.ndarray, max_symbol: int,
                 max_nb_bits: int = HUF_TABLELOG_DEFAULT) -> HufCTable:
    """Build a canonical Huffman code table (HUF_buildCTable_wksp:790).

    Requires >= 2 distinct symbols (RLE handled by the caller).
    """
    counts = np.asarray(counts[: max_symbol + 1], dtype=np.int64)
    lengths = _huffman_lengths(counts)
    if int(lengths.max()) > max_nb_bits:
        lengths = _limit_lengths(lengths, counts, max_nb_bits)
    table_log = int(lengths.max())

    # Canonical value assignment (HUF_readCTable / HUF_buildCTable tail):
    # valPerRank from longest code to shortest; symbols in natural order.
    nb_per_rank = np.zeros(table_log + 2, dtype=np.int64)
    for l in lengths[lengths > 0]:
        nb_per_rank[l] += 1
    val_per_rank = np.zeros(table_log + 2, dtype=np.int64)
    mn = 0
    for l in range(table_log, 0, -1):
        val_per_rank[l] = mn
        mn += nb_per_rank[l]
        mn >>= 1
    code = np.zeros(max_symbol + 1, dtype=np.uint16)
    fill = val_per_rank.copy()
    for s in range(max_symbol + 1):
        l = int(lengths[s])
        if l:
            code[s] = fill[l]
            fill[l] += 1
    return HufCTable(table_log, max_symbol, lengths.astype(np.uint8), code)


def ctable_from_weights(weights: np.ndarray, table_log: int) -> HufCTable:
    """Rebuild the canonical encode table from decoded weights
    (HUF_readCTable semantics) — used for dictionary CTables and
    repeat-mode encoding."""
    max_symbol = len(weights) - 1
    w = weights.astype(np.int64)
    nb = np.where(w > 0, table_log + 1 - w, 0)
    nb_per_rank = np.bincount(nb[nb > 0], minlength=table_log + 2)
    val_per_rank = np.zeros(table_log + 2, dtype=np.int64)
    mn = 0
    for l in range(table_log, 0, -1):
        val_per_rank[l] = mn
        mn += nb_per_rank[l]
        mn >>= 1
    code = np.zeros(max_symbol + 1, dtype=np.uint16)
    fill = val_per_rank.copy()
    for s in range(max_symbol + 1):
        l = int(nb[s])
        if l:
            code[s] = fill[l]
            fill[l] += 1
    return HufCTable(table_log, max_symbol, nb.astype(np.uint8), code)


def write_ctable(ct: HufCTable) -> bytes:
    """Serialize the table as weights (HUF_writeCTable_wksp)."""
    # weight = huffLog + 1 - nbBits for present symbols; 0 for absent.
    nb = ct.nb_bits[: ct.max_symbol + 1].astype(np.int64)
    weights = np.where(nb > 0, ct.table_log + 1 - nb, 0).astype(np.uint8)
    wt = weights[: ct.max_symbol]  # last symbol's weight is implied

    payload = None
    if len(wt) > 1:
        cnt = np.bincount(wt, minlength=13).astype(np.int64)
        nz = np.nonzero(cnt)[0]
        max_count = int(cnt.max())
        if max_count < len(wt) and max_count > 1:
            max_sym_w = int(nz[-1])
            try:
                tlog = fse.optimal_table_log(6, len(wt), max_sym_w)
                norm = fse.normalize_count(cnt[: max_sym_w + 1], tlog, len(wt), max_sym_w, False)
                hdr = fse.write_ncount(norm, max_sym_w, tlog)
                ctab = fse.build_ctable(norm, max_sym_w, tlog)
                body = fse.fse_compress(wt, ctab)
                payload = hdr + body
            except ZstdError:
                payload = None
    # The raw-nibble form caps at 128 weights, so for max_symbol >= 128 the
    # FSE form is mandatory (not merely profitable).
    fse_ok = payload is not None and 1 < len(payload) < 128
    if fse_ok and (len(payload) < ct.max_symbol / 2 or ct.max_symbol >= 128):
        return bytes([len(payload)]) + payload

    # Raw nibble fallback.
    check(ct.max_symbol < 128, ZstdErrorCode.generic, "raw weights need maxSymbol<128")
    padded = np.append(wt, np.uint8(0))
    pairs = (padded[0 : len(wt) : 2].astype(np.uint16) << 4) | padded[1 : len(wt) + 1 : 2]
    return bytes([128 + ct.max_symbol - 1]) + pairs.astype(np.uint8).tobytes()


def encode_1x(symbols: np.ndarray, ct: HufCTable) -> bytes:
    """1-stream encode: symbols consumed back-to-front through the
    prefix-scan bit packer (HUF_compress1X_usingCTable_internal_body:1056)."""
    if len(symbols) > 64:
        from .. import native

        if native.get_lib() is not None:
            code = np.zeros(256, dtype=np.uint16)
            nb = np.zeros(256, dtype=np.uint8)
            code[: ct.max_symbol + 1] = ct.code
            nb[: ct.max_symbol + 1] = ct.nb_bits
            out = native.huf_encode_stream(symbols, code, nb)
            if out is not None:
                return out
    rev = symbols[::-1].astype(np.int64)
    values = ct.code[rev].astype(np.uint64)
    nbits = ct.nb_bits[rev].astype(np.uint64)
    return pack_bits(values, nbits)


def encode_4x(symbols: np.ndarray, ct: HufCTable) -> bytes | None:
    """4-stream encode with jump table (HUF_compress4X_usingCTable:1221).

    Returns None if any sub-stream is degenerate (caller falls back).
    """
    n = len(symbols)
    check(n >= 6, ZstdErrorCode.generic, "4X needs >= 6 bytes")
    seg = (n + 3) // 4
    parts = [symbols[0:seg], symbols[seg : 2 * seg], symbols[2 * seg : 3 * seg], symbols[3 * seg :]]
    if len(parts[3]) == 0:
        return None
    streams = [encode_1x(p, ct) for p in parts]
    if any(len(s) == 0 or len(s) > 65535 for s in streams[:3]):
        return None
    jump = np.array([len(streams[0]), len(streams[1]), len(streams[2])], dtype="<u2")
    return jump.tobytes() + b"".join(streams)
