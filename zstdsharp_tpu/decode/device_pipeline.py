"""End-to-end on-device frame decode: entropy kernels + LZ stitch in HBM.

`decode_batch_device(frames)` decodes a batch of zstd frames wholly on
the device: Huffman literal streams run through the Triton decoder
(ops/device_huf.py), sequence sections through the Triton 3-state FSE
machine (ops/device_fse.py), one launch each for the whole batch, and the
LZ reconstruction through the
pointer-jumping executor (ops/execseq.py).  Outputs are device-resident
uint8 rows in HBM — nothing crosses back to the host except (optionally)
whatever the caller materializes.  This is the deployment shape the
device plane exists for: record-batch decompression feeding on-device
consumers (training input pipelines), where D2H bandwidth never enters.

Coverage envelope (everything else transparently routes to the host
engine, reported in the plan):
  - single-block frames (content <= 128KB), any block type — the record
    workload; raw and RLE blocks are handled on device too (an RLE block
    is a one-byte literal pool row);
  - literal sections: raw, RLE, 4-stream AND 1-stream Huffman on device
    (a 1-stream section is a single kernel lane; only oversized streams
    host-decode into the pool), treeless sections via the dict table;
  - sequence sections: predefined / RLE / fresh-FSE / dict-repeat tables
    (the FSE kernel resolves repcodes internally);
  - dictionary frames when a parsed dict is supplied: the dict content
    tail (<= 128KB) rides as broadcast window rows of the LZ executor,
    entropy starts from the dict tables (ZstdDdict.cs:142 role).
Multi-block frames (content <= 4MB, window <= 4MB) decode as DEPENDENT
EXECUTION ROUNDS: the plan walks every block host-side (chaining the
repcode and repeat-table state the format threads through the payload,
and host-decoding sequence sections so those chains resolve at plan
time), then round r executes block r of every such frame in parallel,
each lane's window sliced from a zero-padded device accumulator the
previous rounds wrote.  Parallelism across frames is preserved; the
serial dependency the format imposes within a frame costs rounds, not
lanes (SURVEY.md §2.7).

Integrity: plan time validates what is cheap on the host (block bounds vs
frame length, raw/RLE size vs content size, literal-section bounds) and
host-routes violations so the host engine raises the proper taxonomy;
``materialize=True`` additionally verifies the stored xxh64 content
checksum of every device-decoded frame (checksum_wrong on mismatch).
The device-resident path (``materialize=False``) returns rows that have
NOT been checksum-verified — the executor clips out-of-range offsets
rather than faulting, so that path assumes trusted input, exactly like
feeding unverified records to any on-device input pipeline.  Callers
needing verification on device-resident rows can hash via
``utils.xxhash`` after their own materialization.

Reference behavior mirrored: ZSTD_decompressBlock_internal:3090 stage
order, ZSTD_execSequence:2187 byte semantics (via ops/execseq.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import constants as C
from ..entropy import huffman
from .block import EntropyState, decode_sequence_headers
from .frame import parse_frame_header

# exec batching: lanes per exec call x output bucket (one fused dispatch
# covers assembly + LZ execution for EXEC_LANES frames)
EXEC_LANES = 64
_O_BUCKETS = (1 << 12, 24576, 1 << 15, 1 << 17)
_S_BUCKETS = (256, 1024, 4096, 8192, 16384, 32768)
# multi-block envelope: total content / window the dependent-round
# executor supports (accumulator memory: F x (W + content))
MB_CONTENT_CAP = 1 << 22
MB_WINDOW_CAP = 1 << 22
_MBC_BUCKETS = (1 << 18, 1 << 20, 1 << 22)
_MBW_BUCKETS = (1 << 15, 1 << 17, 1 << 20, 1 << 22)


class _CodedDT:
    """FseDTable view exposing the per-state CODE (device tables carry the
    code; value bases come from the shared constant tables)."""

    def __init__(self, dt, kind):
        self.table_log = dt.table_log
        self.new_state = np.asarray(dt.new_state)
        self.nb_bits = np.asarray(dt.nb_bits)
        base = np.asarray(dt.base_value, np.int64)
        if kind == "of":
            self.symbol = np.asarray(dt.nb_add_bits, np.int64)
        elif kind == "ll":
            self.symbol = np.searchsorted(np.asarray(C.LL_BASE, np.int64), base)
        else:
            self.symbol = np.searchsorted(np.asarray(C.ML_BASE, np.int64), base)


@dataclass
class _BlockPlan:
    frame_idx: int
    out_len: int
    lit_regen: int
    # stored xxh64 content checksum (low 32 bits), or -1 if absent
    checksum: int = -1
    # literals: kind 0 = raw pool span, 1 = huf 4-stream section
    lit_kind: int = 0
    pool_base: int = 0
    pool_len: int = 0
    huf_lane0: int = -1
    huf_seg: int = 0
    # sequences: kind 0 = none, 1 = device FSE lane, 2 = host arrays row
    seq_kind: int = 0
    fse_lane: int = -1
    host_row: int = -1
    n_seq: int = 0
    out_off: int = 0   # multi-block: output offset within the frame


@dataclass
class DevicePlan:
    blocks: list = field(default_factory=list)
    raw_pool: bytearray = field(default_factory=bytearray)
    huf_payloads: list = field(default_factory=list)
    huf_weights: list = field(default_factory=list)
    huf_nsyms: list = field(default_factory=list)
    fse_payloads: list = field(default_factory=list)
    fse_tables: list = field(default_factory=list)
    fse_nseqs: list = field(default_factory=list)
    fse_reps: list = field(default_factory=list)
    host_seqs: list = field(default_factory=list)  # (ll, ml, of) np arrays
    host_routed: dict = field(default_factory=dict)  # frame_idx -> reason
    n_frames: int = 0
    max_out: int = 0
    max_seq: int = 0
    # dictionary window shared by every dict-framed lane (right-aligned
    # tail of the dict content; broadcast once to the device)
    window: bytes = b""
    # multi-block frames: list of dicts {frame_idx, content, checksum,
    # blocks: [_BlockPlan with out_len/out_off per block]}
    mb_frames: list = field(default_factory=list)
    # native operand buffers (_NativeOps) when the C planner is active; all
    # lanes and the raw pool then live in its packed arrays instead of the
    # payload lists above
    nb: object = None

    # ---- lane/pool helpers: one numbering whether lanes are packed by the
    # native planner, the native pack entry points, or the Python lists ----

    def pool_add(self, b) -> int:
        if self.nb is not None:
            return self.nb.pool_add(bytes(b))
        base = len(self.raw_pool)
        self.raw_pool += b
        return base

    def add_huf_lane(self, payload, weights, n_out) -> int:
        if self.nb is not None:
            lane = self.nb.pack_huf(bytes(payload), weights, n_out)
            if lane >= 0:
                return lane
            raise ValueError("corrupt stream: zero last byte")
        self.huf_payloads.append(payload)
        self.huf_weights.append(weights)
        self.huf_nsyms.append(n_out)
        return len(self.huf_payloads) - 1

    def add_fse_lane(self, payload, dts, nseq, rep) -> int:
        if self.nb is not None:
            lane = self.nb.pack_fse(bytes(payload), dts, rep, nseq)
            if lane >= 0:
                self.max_seq = max(self.max_seq, nseq)
                return lane
            raise ValueError("corrupt stream: zero last byte")
        ll_dt, of_dt, ml_dt = dts
        self.fse_payloads.append(payload)
        self.fse_tables.append((_CodedDT(ll_dt, "ll"), _CodedDT(of_dt, "of"),
                                _CodedDT(ml_dt, "ml")))
        self.fse_nseqs.append(nseq)
        self.fse_reps.append(list(rep))
        self.max_seq = max(self.max_seq, nseq)
        return len(self.fse_payloads) - 1


# Host-route reasons by native planner code (zt_dplane_frame).
_NATIVE_ROUTE = {
    1: "no content size",
    2: "dictionary required",
    3: "content/window beyond device caps",
    4: "corrupt: truncated block",
    5: "corrupt: block size",
    6: "corrupt: literal section bounds",
    7: "treeless literals, no dict table",
    8: "corrupt: reserved block type",
    9: "corrupt: huffman weights",
    10: "corrupt: sequence headers",
}


class _NativeOps:
    """Packed device operands, filled by the native planner (ZtDPlaneCtx).

    Buffers are numpy arrays in LANE-MAJOR layout (one contiguous row per
    lane) so the C planner packs with sequential memcpys; `huf_ops` /
    `fse_ops` hand every packed lane of the batch to
    ops.device_huf.decode_lanemajor / ops.device_fse.decode_lanemajor,
    which decode them in one launch each."""

    LANES = 1024      # allocation quantum of the lane buffers
    HUF_MAXW = 2048   # == ops.device_huf.MAX_W
    FSE_MAXW = 2048   # == ops.device_fse.MAX_W
    S_CAP = 32768     # == _S_BUCKETS[-1]

    def __init__(self, lib, n_frames: int, total_in: int):
        import ctypes

        self._ctypes = ctypes
        self.lib = lib
        from .. import native

        self.ctx = native.DPlaneCtx()
        self._meta = np.zeros(12, np.int32)
        # fence: last device output of the batch that consumed this ctx's
        # buffers; ready ⟹ every h2d transfer from them has completed, so
        # the buffers are safe to overwrite (pool recycling)
        self.fence = None
        huf_cap = -(-max(4 * n_frames, 4) // self.LANES) * self.LANES
        fse_cap = -(-max(n_frames, 1) // self.LANES) * self.LANES
        pool_cap = total_in + (1 << 17) + 64
        self._alloc_huf(huf_cap)
        self._alloc_fse(fse_cap)
        self._alloc_pool(pool_cap)
        self.ctx.s_cap = self.S_CAP
        self.ctx.huf_maxw = self.HUF_MAXW
        self.ctx.fse_maxw = self.FSE_MAXW

    def reset(self, n_frames: int, total_in: int):
        """Rearm a pooled ctx for a new batch.  Stale row contents are
        harmless (only the batch's own lanes are handed to the kernels;
        table tails beyond 2^log are never state-selected; pool spans are
        fully overwritten), so no buffer clearing is needed — that is the
        point of pooling: ~34MB of first-touch page faults per batch go
        away."""
        c = self.ctx
        c.pool_off = 0
        c.n_huf = 0
        c.n_fse = 0
        c.huf_wmax = 0
        c.fse_wmax = 0
        c.max_seq = 0
        c.max_out = 0
        self.fence = None
        huf_need = -(-max(4 * n_frames, 4) // self.LANES) * self.LANES
        fse_need = -(-max(n_frames, 1) // self.LANES) * self.LANES
        pool_need = total_in + (1 << 17) + 64
        if huf_need > c.huf_cap:
            self._alloc_huf(huf_need)
        if fse_need > c.fse_cap:
            self._alloc_fse(fse_need)
        if pool_need > c.pool_cap:
            self._alloc_pool(pool_need)

    # -- allocation / growth (pointers live in the ctx struct) --

    def _i32p(self, a):
        return a.ctypes.data_as(
            self._ctypes.POINTER(self._ctypes.c_int32))

    def _alloc_huf(self, cap, old=None):
        z = lambda *s: np.zeros(s, np.int32)
        arrs = dict(
            huf_words=z(cap, self.HUF_MAXW), huf_limits=z(cap, 16),
            huf_bases=z(cap, 16), huf_offs=z(cap, 16),
            huf_shifts=z(cap, 16), huf_planes=z(cap, 64), huf_pos=z(cap),
            huf_nsym=z(cap), huf_wlen=z(cap))
        if old is not None:
            oc = old["huf_words"].shape[0]
            for k, a in arrs.items():
                a[:oc] = old[k]
        self._huf = arrs
        ct = self._ctypes
        self.ctx.huf_cap = cap
        self.ctx.huf_words = arrs["huf_words"].ctypes.data_as(
            ct.POINTER(ct.c_uint32))
        for k in ("huf_limits", "huf_bases", "huf_offs", "huf_shifts",
                  "huf_planes", "huf_pos", "huf_nsym", "huf_wlen"):
            setattr(self.ctx, k, self._i32p(arrs[k]))

    def _alloc_fse(self, cap, old=None):
        z = lambda *s: np.zeros(s, np.int32)
        arrs = dict(
            fse_words=z(cap, self.FSE_MAXW), fse_ll=z(cap, 512),
            fse_of=z(cap, 256), fse_ml=z(cap, 512), fse_logs=z(cap, 3),
            fse_pos=z(cap), fse_rep=z(cap, 3), fse_nseq=z(cap),
            fse_wlen=z(cap), fse_st=z(cap, 8))
        if old is not None:
            oc = old["fse_words"].shape[0]
            for k, a in arrs.items():
                a[:oc] = old[k]
        self._fse = arrs
        ct = self._ctypes
        self.ctx.fse_cap = cap
        self.ctx.fse_words = arrs["fse_words"].ctypes.data_as(
            ct.POINTER(ct.c_uint32))
        for k in ("fse_ll", "fse_of", "fse_ml", "fse_logs", "fse_pos",
                  "fse_rep", "fse_nseq", "fse_wlen", "fse_st"):
            setattr(self.ctx, k, self._i32p(arrs[k]))

    def _alloc_pool(self, cap, old=None):
        pool = np.zeros(cap, np.uint8)
        if old is not None:
            pool[: len(old)] = old
        self._pool = pool
        ct = self._ctypes
        self.ctx.pool_cap = cap
        self.ctx.raw_pool = pool.ctypes.data_as(ct.POINTER(ct.c_uint8))

    def _ensure(self, pool_need=1 << 17, huf_need=4, fse_need=1):
        c = self.ctx
        if c.pool_off + pool_need + 8 > c.pool_cap:
            self._alloc_pool(
                max(c.pool_cap * 2, c.pool_off + pool_need + 64),
                old=self._pool[: c.pool_off])
        if c.n_huf + huf_need > c.huf_cap:
            self._alloc_huf(
                -(-max(c.huf_cap * 2, c.n_huf + huf_need)
                  // self.LANES) * self.LANES, old=self._huf)
        if c.n_fse + fse_need > c.fse_cap:
            self._alloc_fse(
                -(-max(c.fse_cap * 2, c.n_fse + fse_need)
                  // self.LANES) * self.LANES, old=self._fse)

    # -- entry points --

    def _u8p(self, b: bytes):
        ct = self._ctypes
        v = np.frombuffer(b, np.uint8)
        return v.ctypes.data_as(ct.POINTER(ct.c_uint8)), v

    def plan_frame(self, frame):
        """Run the native planner on one frame.  Returns (rc, meta)."""
        self._ensure()
        ct = self._ctypes
        p, ref = self._u8p(bytes(frame))
        rc = self.lib.zt_dplane_frame(ct.byref(self.ctx), p, len(ref),
                                      self._i32p(self._meta))
        return rc, self._meta

    def plan_all(self, frames):
        """Plan every frame in one native call.  Returns (rcs [N] i32,
        metas [N, 12] i32) — same meta layout as plan_frame."""
        ct = self._ctypes
        n = len(frames)
        buf = b"".join(map(bytes, frames))
        lens = np.fromiter(map(len, frames), np.int64, n)
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        self._ensure(pool_need=len(buf), huf_need=4 * n, fse_need=n)
        metas = np.zeros((n, 12), np.int32)
        rcs = np.zeros(n, np.int32)
        bufv = np.frombuffer(buf, np.uint8)
        self.lib.zt_dplane_batch(
            ct.byref(self.ctx),
            bufv.ctypes.data_as(ct.POINTER(ct.c_uint8)),
            offs.ctypes.data_as(ct.POINTER(ct.c_int64)),
            n, self._i32p(metas), self._i32p(rcs))
        return rcs, metas

    def pack_huf(self, payload: bytes, weights, n_out: int) -> int:
        self._ensure(pool_need=0, huf_need=1, fse_need=0)
        w = np.ascontiguousarray(np.asarray(weights, np.uint8))
        total = int(((np.uint64(1) << w[w > 0].astype(np.uint64)).sum())
                    >> np.uint64(1))
        tlog = max(int(total).bit_length() - 1 if total else 1, 1)
        ct = self._ctypes
        p, ref = self._u8p(payload)
        return int(self.lib.zt_dplane_pack_huf(
            ct.byref(self.ctx), p, len(ref),
            w.ctypes.data_as(ct.POINTER(ct.c_uint8)), len(w), tlog, n_out))

    def pack_fse(self, payload: bytes, dts, rep, nseq: int) -> int:
        from ..ops import device_fse as df

        self._ensure(pool_need=0, huf_need=0, fse_need=1)
        ll_dt, of_dt, ml_dt = dts
        ll = np.ascontiguousarray(df.pack_table(ll_dt).astype(np.int32))
        of = np.ascontiguousarray(
            df.pack_table(of_dt)[:256].astype(np.int32))
        ml = np.ascontiguousarray(df.pack_table(ml_dt).astype(np.int32))
        r3 = np.asarray(list(rep), np.int32)
        ct = self._ctypes
        p, ref = self._u8p(payload)
        return int(self.lib.zt_dplane_pack_fse(
            ct.byref(self.ctx), p, len(ref),
            self._i32p(ll), self._i32p(of), self._i32p(ml),
            int(ll_dt.table_log), int(of_dt.table_log),
            int(ml_dt.table_log), self._i32p(r3), nseq))

    def pool_add(self, b: bytes) -> int:
        self._ensure(pool_need=len(b), huf_need=0, fse_need=0)
        base = int(self.ctx.pool_off)
        self._pool[base: base + len(b)] = np.frombuffer(b, np.uint8)
        self.ctx.pool_off = base + len(b)
        return base

    # -- batched operand views --

    @property
    def n_huf(self):
        return int(self.ctx.n_huf)

    @property
    def n_fse(self):
        return int(self.ctx.n_fse)

    def pool_array(self) -> np.ndarray:
        return self._pool[: int(self.ctx.pool_off)]

    def huf_ops(self) -> dict:
        """Lane-major operands of every packed Huffman lane, for
        ops.device_huf.decode_lanemajor (words cut to the batch's width
        bucket; views of the ctx buffers, copied when the wrapper pads
        them to the lane bucket)."""
        from ..ops import device_huf as dh

        a = self._huf
        n = self.n_huf
        wb = dh.bucket_w(int(a["huf_wlen"][:n].max()))
        return dict(
            words=a["huf_words"][:n, :wb], limits=a["huf_limits"][:n],
            bases=a["huf_bases"][:n], offs=a["huf_offs"][:n],
            shifts=a["huf_shifts"][:n], planes=a["huf_planes"][:n],
            pos=a["huf_pos"][:n], n_sym=a["huf_nsym"][:n],
            t_max=int(a["huf_nsym"][:n].max()))

    def fse_ops(self) -> dict:
        """Lane-major operands of every packed FSE lane, for
        ops.device_fse.decode_lanemajor."""
        from ..ops import device_fse as df

        a = self._fse
        n = self.n_fse
        wb = df.bucket_w(int(a["fse_wlen"][:n].max()))
        return dict(
            words=a["fse_words"][:n, :wb],
            ll=a["fse_ll"][:n], of=a["fse_of"][:n], ml=a["fse_ml"][:n],
            st=a["fse_st"][:n], n_seq=a["fse_nseq"][:n],
            t_max=int(a["fse_nseq"][:n].max()))


_CTX_POOL: list = []
_CTX_LOCK = None


def _native_ops_for(frames):
    """A _NativeOps for this batch, or None (no toolchain / disabled).
    Recycles pooled contexts: a fresh ctx costs ~34MB of first-touch page
    faults per batch (~10ms); a pooled one is rearmed in O(1) once its
    fence (the previous batch's last output) is ready."""
    global _CTX_LOCK
    import os
    import threading

    if os.environ.get("ZT_NO_NATIVE_PLAN"):
        return None
    from .. import native

    lib = native.get_lib()
    if lib is None or not hasattr(lib, "zt_dplane_frame"):
        return None
    total = sum(len(f) for f in frames)
    if _CTX_LOCK is None:
        _CTX_LOCK = threading.Lock()
    with _CTX_LOCK:
        nb = _CTX_POOL.pop() if _CTX_POOL else None
    if nb is not None:
        if nb.fence is not None:
            import jax

            jax.block_until_ready(nb.fence)
        nb.reset(len(frames), total)
        return nb
    return _NativeOps(lib, len(frames), total)


def _release_ops(nb, fence):
    """Return a ctx to the pool once its batch has dispatched; `fence` is
    the batch's last device output (ready ⟹ h2d transfers complete)."""
    if nb is None or _CTX_LOCK is None:
        return
    nb.fence = fence
    with _CTX_LOCK:
        if len(_CTX_POOL) < 4:
            _CTX_POOL.append(nb)


def _parse_lit_header(payload: bytes):
    """(lit_type, size_format, regen, comp, header_bytes)."""
    b0 = payload[0]
    lt, sf = b0 & 3, (b0 >> 2) & 3
    if lt in (0, 1):
        if sf in (0, 2):
            return lt, sf, b0 >> 3, 0, 1
        if sf == 1:
            v = int.from_bytes(payload[0:2], "little")
            return lt, sf, v >> 4, 0, 2
        v = int.from_bytes(payload[0:3], "little")
        return lt, sf, v >> 4, 0, 3
    if sf in (0, 1):
        v = int.from_bytes(payload[0:3], "little")
        return lt, sf, (v >> 4) & 0x3FF, (v >> 14) & 0x3FF, 3
    if sf == 2:
        v = int.from_bytes(payload[0:4], "little")
        return lt, sf, (v >> 4) & 0x3FFF, (v >> 18) & 0x3FFF, 4
    v = int.from_bytes(payload[0:5], "little")
    return lt, sf, (v >> 4) & 0x3FFFF, (v >> 22) & 0x3FFFF, 5


def scan_eligibility(frames, ddict=None,
                     single_block_only: bool = False) -> dict:
    """Cheap header-only partition probe: frame_idx -> host-route reason
    for frames outside the device envelope (ADVICE r3: the partitioner
    must not run the full ``plan_batch`` — which host-decodes fallback
    literal/sequence sections — twice per frame).  Examines only the
    frame header, first block header, and the literal-section type byte;
    mirrors exactly the routing conditions of ``plan_batch``."""
    routed = {}
    d_id = ddict.dict_id if ddict is not None else 0
    has_dict_huf = ddict is not None and ddict.entropy is not None
    for fi, frame in enumerate(frames):
        try:
            buf = np.frombuffer(frame, np.uint8)
            hdr = parse_frame_header(buf)
            if hdr.frame_content_size is None or hdr.frame_content_size < 0:
                routed[fi] = "no content size"
                continue
            if hdr.dict_id and hdr.dict_id != d_id:
                routed[fi] = "dictionary required"
                continue
            content = int(hdr.frame_content_size)
            if content > MB_CONTENT_CAP or (
                    content > (1 << 17)
                    and hdr.window_size > MB_WINDOW_CAP):
                routed[fi] = "content/window beyond device caps"
                continue
            if single_block_only and content > (1 << 17):
                routed[fi] = "multi-block (host preferred)"
                continue
            p = hdr.header_size
            bh = int.from_bytes(frame[p:p + 3], "little")
            last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
            if not last:
                if single_block_only:
                    routed[fi] = "multi-block (host preferred)"
                continue  # multi-block: device-planned (dependent rounds)
            body_len = bsize if btype != 1 else 1
            tail = 4 if hdr.has_checksum else 0
            if p + 3 + body_len + tail > len(frame):
                routed[fi] = "corrupt: truncated block"
                continue
            if btype in (0, 1):
                if bsize != content:
                    routed[fi] = "corrupt: block size"
                continue
            payload = bytes(frame[p + 3:p + 3 + min(bsize, 5)])
            lt, sf, regen, comp, lh = _parse_lit_header(payload)
            if lt == 3 and not has_dict_huf:
                routed[fi] = "treeless literals, no dict table"
            elif regen > content or lh + (comp if lt >= 2 else 0) > bsize:
                routed[fi] = "corrupt: literal section bounds"
        except Exception as e:  # pragma: no cover - defensive routing
            routed[fi] = f"plan error: {e}"
    return routed


def _plan_multiblock(plan, fi, frame, hdr, ddict, d_weights):
    """Walk every block of a multi-block frame: literal sections become
    device lanes (or pool spans), sequence sections are host-decoded so
    the repcode and repeat-table chains resolve at plan time (the
    reference's decoder chains them block to block,
    ZSTD_decompressBlock_internal:3090), and each block records its
    output offset for the dependent-round executor.  Returns an error
    string to host-route, or None on success."""
    from ..ops import device_fse as df
    from ..ops import device_huf as dh
    from .block import decode_literals, decode_sequences

    content = int(hdr.frame_content_size)
    if ddict is not None and ddict.entropy is not None:
        de = ddict.entropy
        ent = EntropyState(huf=de.huf, ll=de.ll, ml=de.ml, of=de.of,
                          rep=list(de.rep))
    else:
        ent = EntropyState()
    blocks = []
    p = hdr.header_size
    out_off = 0
    while True:
        if p + 3 > len(frame):
            return "corrupt: truncated block header"
        bh = int.from_bytes(frame[p:p + 3], "little")
        last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
        p += 3
        body_len = bsize if btype != 1 else 1
        if p + body_len > len(frame):
            return "corrupt: truncated block"
        b = _BlockPlan(frame_idx=fi, out_len=0, lit_regen=0)
        b.out_off = out_off
        if btype == 0:
            b.pool_base = plan.pool_add(frame[p:p + bsize])
            b.pool_len = bsize
            b.lit_regen = bsize
            b.out_len = bsize
        elif btype == 1:
            b.pool_base = plan.pool_add(frame[p:p + 1])
            b.pool_len = 1
            b.lit_regen = bsize
            b.out_len = bsize
        elif btype == 2:
            payload = bytes(frame[p:p + bsize])
            lt, sf, regen, comp, lh = _parse_lit_header(payload)
            if lh + (comp if lt >= 2 else 0) > len(payload):
                return "corrupt: literal section bounds"
            b.lit_regen = regen
            if lt == 0:
                b.pool_base = plan.pool_add(payload[lh:lh + regen])
                b.pool_len = regen
                lit_end = lh + regen
            elif lt == 1:
                b.pool_base = plan.pool_add(payload[lh:lh + 1])
                b.pool_len = 1
                lit_end = lh + 1
            else:
                body = payload[lh:lh + comp]
                if lt == 2:
                    weights, tlog, whdr = huffman.read_weights(body)
                    ent.huf = huffman.build_dtable(weights, tlog)
                    # kernel peek window is MAXLOG=11 bits; a (valid)
                    # tableLog-12 tree must host-decode, not drop
                    # weight-12 symbols in the device classifier
                    if tlog > dh.MAXLOG:
                        weights = None
                elif ent.huf is not None:
                    weights, whdr = None, 0
                else:
                    return "treeless literals, no table"
                ok_dev = False
                streams = body[whdr:]
                if weights is not None and sf != 0 and len(streams) >= 10:
                    s1 = int.from_bytes(streams[0:2], "little")
                    s2 = int.from_bytes(streams[2:4], "little")
                    s3 = int.from_bytes(streams[4:6], "little")
                    sizes = [s1, s2, s3, len(streams) - 6 - s1 - s2 - s3]
                    seg = (regen + 3) // 4
                    outs = [seg, seg, seg, regen - 3 * seg]
                    if (min(sizes) > 0 and min(outs) > 0
                            and max(sizes) <= dh.MAX_W * 4):
                        b.lit_kind = 1
                        b.huf_seg = seg
                        off = 6
                        for si in range(4):
                            lane = plan.add_huf_lane(
                                streams[off:off + sizes[si]], weights,
                                outs[si])
                            if si == 0:
                                b.huf_lane0 = lane
                            off += sizes[si]
                        ok_dev = True
                elif (weights is not None and sf == 0
                      and 0 < len(streams) <= dh.MAX_W * 4
                      and 0 < regen <= 4096):
                    b.lit_kind = 1
                    b.huf_seg = regen
                    b.huf_lane0 = plan.add_huf_lane(streams, weights, regen)
                    ok_dev = True
                if not ok_dev:
                    lits, _ = decode_literals(payload, ent)
                    b.pool_base = plan.pool_add(lits.tobytes())
                    b.pool_len = regen
                lit_end = lh + comp
            # sequence section: host decode (chains ent + reps)
            rest = payload[lit_end:]
            nbseq, ll_dt, of_dt, ml_dt, consumed =                 decode_sequence_headers(rest, ent)
            b.n_seq = nbseq
            if nbseq > 0:
                if nbseq > _S_BUCKETS[-1]:
                    return "sequence count beyond device bucket"
                lls, mls, ofs = decode_sequences(
                    rest[consumed:], nbseq, ll_dt, of_dt, ml_dt, ent.rep)
                b.seq_kind = 2
                b.host_row = len(plan.host_seqs)
                plan.host_seqs.append((lls, mls, ofs))
                plan.max_seq = max(plan.max_seq, nbseq)
                b.out_len = int(np.sum(mls)) + b.lit_regen
            else:
                b.out_len = b.lit_regen
        else:
            return "corrupt: reserved block type"
        out_off += b.out_len
        if out_off > content:
            return "corrupt: content overflow"
        blocks.append(b)
        p += body_len
        if last:
            break
    if out_off != content:
        return "corrupt: content size mismatch"
    cks = -1
    if hdr.has_checksum:
        if p + 4 > len(frame):
            return "corrupt: missing checksum"
        cks = int.from_bytes(frame[p:p + 4], "little")
    wsize = min(int(hdr.window_size or content), MB_WINDOW_CAP)
    plan.mb_frames.append({"frame_idx": fi, "content": content,
                           "checksum": cks, "window": wsize,
                           "blocks": blocks})
    return None


def plan_batch(frames, ddict=None) -> DevicePlan:
    """Host header pass: split each frame into device work or a host
    route.  Only headers and table descriptions are examined — payload
    bytes go to the device untouched (raw literal spans are sliced).

    ddict: optional parsed dictionary (dictionary.ParsedDict).  Dict
    frames then run on device: the dict content tail becomes the shared
    window rows, the dict entropy state seeds table/repcode decoding
    (treeless literal sections resolve against the dict Huffman table),
    mirroring ZSTD_decompressBegin_usingDDict (ZstdDdict.cs:142).
    Dicts larger than 128KB host-route (window-row envelope)."""
    from ..ops import device_fse as df
    from ..ops import device_huf as dh

    plan = DevicePlan(n_frames=len(frames))
    d_id = 0
    d_weights, d_tlog = None, 0
    if ddict is not None:
        d_id = ddict.dict_id
        content = np.asarray(ddict.content)
        plan.window = content[-(1 << 17):].tobytes()
        if ddict.entropy is not None and len(ddict.raw) >= 8:
            d_weights, d_tlog, _ = huffman.read_weights(ddict.raw[8:])
    else:
        # native planner: single-block frames plan in C (the Python pass
        # below measured ~850ms per 256-frame batch vs ~5ms native); frames
        # outside its scope fall through to the Python logic, whose lanes
        # pack into the same native operand buffers
        plan.nb = _native_ops_for(frames)
    rcs = metas = None
    if plan.nb is not None:
        rcs, metas = plan.nb.plan_all(frames)
    for fi, frame in enumerate(frames):
        if plan.nb is not None:
            rc, m = int(rcs[fi]), metas[fi]
            if rc == 0:
                # meta[7] carries the has-checksum flag: -1 in meta[11]
                # alone cannot distinguish "absent" from a real stored
                # xxh32 low word of 0xFFFFFFFF
                raw_cks = int(m[11])
                plan.blocks.append(_BlockPlan(
                    frame_idx=fi, out_len=int(m[10]), lit_regen=int(m[9]),
                    checksum=(raw_cks & 0xFFFFFFFF) if int(m[7]) else -1,
                    lit_kind=int(m[0]), pool_base=int(m[1]),
                    pool_len=int(m[2]), huf_lane0=int(m[3]),
                    huf_seg=int(m[4]), seq_kind=int(m[5]),
                    fse_lane=int(m[6]), host_row=-1, n_seq=int(m[8])))
                plan.max_out = max(plan.max_out, int(m[10]))
                if int(m[5]) == 1:
                    plan.max_seq = max(plan.max_seq, int(m[8]))
                continue
            if rc > 0:
                plan.host_routed[fi] = _NATIVE_ROUTE.get(
                    rc, f"native route {rc}")
                continue
            # rc < 0: outside native scope — Python planner below
        try:
            buf = np.frombuffer(frame, np.uint8)
            hdr = parse_frame_header(buf)
            if hdr.frame_content_size is None or hdr.frame_content_size < 0:
                plan.host_routed[fi] = "no content size"
                continue
            if hdr.dict_id and hdr.dict_id != d_id:
                plan.host_routed[fi] = "dictionary required"
                continue
            if ddict is not None and len(np.asarray(ddict.content)) > (1 << 17):
                plan.host_routed[fi] = "dict > 128KB window envelope"
                continue
            content = int(hdr.frame_content_size)
            if content > MB_CONTENT_CAP or (
                    content > (1 << 17)
                    and hdr.window_size > MB_WINDOW_CAP):
                plan.host_routed[fi] = "content/window beyond device caps"
                continue
            p = hdr.header_size
            bh = int.from_bytes(frame[p:p + 3], "little")
            last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
            if not last:
                # multi-block: dependent-round plan (repcode/entropy
                # chains resolved host-side; execution on device)
                err = _plan_multiblock(plan, fi, frame, hdr, ddict,
                                       d_weights)
                if err:
                    plan.host_routed[fi] = err
                continue
            # structural validation (cheap on host; the device executor
            # clips instead of faulting, so corrupt frames must not reach
            # it silently — host engine raises the right taxonomy)
            body_len = bsize if btype != 1 else 1
            tail = 4 if hdr.has_checksum else 0
            if p + 3 + body_len + tail > len(frame):
                plan.host_routed[fi] = "corrupt: truncated block"
                continue
            b = _BlockPlan(frame_idx=fi, out_len=content, lit_regen=0)
            if ddict is not None and ddict.entropy is not None:
                de = ddict.entropy
                ent0 = EntropyState(huf=de.huf, ll=de.ll, ml=de.ml,
                                    of=de.of, rep=list(de.rep))
            else:
                ent0 = EntropyState()
            if hdr.has_checksum:
                b.checksum = int.from_bytes(
                    frame[p + 3 + body_len:p + 3 + body_len + 4], "little")
            if btype == 0:  # raw block
                if bsize != content:
                    plan.host_routed[fi] = "corrupt: raw block size"
                    continue
                b.lit_kind = 0
                b.pool_base = plan.pool_add(frame[p + 3:p + 3 + bsize])
                b.pool_len = bsize
                b.lit_regen = bsize
                plan.blocks.append(b)
                plan.max_out = max(plan.max_out, content)
                continue
            if btype == 1:  # RLE block
                if bsize != content:
                    plan.host_routed[fi] = "corrupt: RLE block size"
                    continue
                b.lit_kind = 0
                b.pool_base = plan.pool_add(frame[p + 3:p + 4])
                b.pool_len = 1
                b.lit_regen = content
                plan.blocks.append(b)
                plan.max_out = max(plan.max_out, content)
                continue
            payload = bytes(frame[p + 3:p + 3 + bsize])
            lt, sf, regen, comp, lh = _parse_lit_header(payload)
            if regen > content or lh + (comp if lt >= 2 else 0) > len(payload):
                plan.host_routed[fi] = "corrupt: literal section bounds"
                continue
            b.lit_regen = regen
            ent = ent0
            if lt == 0:  # raw literals
                b.pool_base = plan.pool_add(payload[lh:lh + regen])
                b.pool_len = regen
                lit_end = lh + regen
            elif lt == 1:  # RLE literals
                b.pool_base = plan.pool_add(payload[lh:lh + 1])
                b.pool_len = 1
                lit_end = lh + 1
            elif lt >= 2:  # Huffman literals (2 fresh tree, 3 treeless)
                body = payload[lh:lh + comp]
                if lt == 2:
                    weights, tlog, whdr = huffman.read_weights(body)
                elif d_weights is not None:
                    # treeless: resolve against the dict Huffman table
                    weights, tlog, whdr = d_weights, d_tlog, 0
                else:
                    plan.host_routed[fi] = "treeless literals, no dict table"
                    continue
                if tlog > dh.MAXLOG:
                    # device kernel peeks 11 bits; tableLog-12 trees (valid
                    # per format) host-route instead of mis-decoding
                    plan.host_routed[fi] = "huffman tableLog beyond device"
                    continue
                streams = body[whdr:]
                four = sf != 0
                ok_dev = False
                if four and len(streams) >= 10:
                    s1 = int.from_bytes(streams[0:2], "little")
                    s2 = int.from_bytes(streams[2:4], "little")
                    s3 = int.from_bytes(streams[4:6], "little")
                    sizes = [s1, s2, s3, len(streams) - 6 - s1 - s2 - s3]
                    seg = (regen + 3) // 4
                    outs = [seg, seg, seg, regen - 3 * seg]
                    if (min(sizes) > 0 and min(outs) > 0
                            and max(sizes) <= dh.MAX_W * 4):
                        b.lit_kind = 1
                        b.huf_seg = seg
                        off = 6
                        for s in range(4):
                            lane = plan.add_huf_lane(
                                streams[off:off + sizes[s]], weights,
                                outs[s])
                            if s == 0:
                                b.huf_lane0 = lane
                            off += sizes[s]
                        ok_dev = True
                elif (not four and 0 < len(streams) <= dh.MAX_W * 4
                      and 0 < regen <= 4096):
                    # single-stream section: one kernel lane; huf_seg =
                    # regen makes the 4-way stitch read quarter 0 only
                    b.lit_kind = 1
                    b.huf_seg = regen
                    b.huf_lane0 = plan.add_huf_lane(streams, weights, regen)
                    ok_dev = True
                if not ok_dev:
                    # oversized stream: host-decode into the pool
                    from .block import decode_literals

                    lits, _ = decode_literals(payload, ent0)
                    b.pool_base = plan.pool_add(lits.tobytes())
                    b.pool_len = regen
                lit_end = lh + comp
            # sequence section
            rest = payload[lit_end:]
            nbseq, ll_dt, of_dt, ml_dt, consumed = \
                decode_sequence_headers(rest, ent)
            b.n_seq = nbseq
            if nbseq > 0:
                seq_payload = rest[consumed:]
                if (len(seq_payload) <= df.MAX_W * 4
                        and of_dt.table_log <= 8
                        and nbseq <= _S_BUCKETS[-1]):
                    b.seq_kind = 1
                    b.fse_lane = plan.add_fse_lane(
                        seq_payload, (ll_dt, of_dt, ml_dt), nbseq, ent.rep)
                else:
                    from .block import decode_sequences

                    lls, mls, ofs = decode_sequences(
                        seq_payload, nbseq, ll_dt, of_dt, ml_dt,
                        list(ent.rep))
                    b.seq_kind = 2
                    b.host_row = len(plan.host_seqs)
                    plan.host_seqs.append((lls, mls, ofs))
                plan.max_seq = max(plan.max_seq, nbseq)
            plan.blocks.append(b)
            plan.max_out = max(plan.max_out, content)
        except Exception as e:  # pragma: no cover - defensive routing
            plan.host_routed[fi] = f"plan error: {e}"
    return plan


def _bucket(v, buckets):
    for x in buckets:
        if v <= x:
            return x
    raise ValueError(f"{v} exceeds device envelope {buckets[-1]}")


def _pool_bucket(n: int) -> int:
    """Upload length of an n-byte raw pool: a power of two (at least
    4 KiB), so batches of a like size share one compiled executor instead
    of tracing it anew for every pool length.  The pool holds only raw
    and RLE literals, which for compressible records is small beside the
    batch, so padding it by up to 2x costs little upload."""
    return max(1 << (n - 1).bit_length(), 1 << 12)


def decode_batch_device(frames, materialize: bool = False, ddict=None):
    """Decode a batch of frames on the device.

    Returns (outputs, lengths, host_results) where outputs is a list of
    per-exec-chunk device arrays [EXEC_LANES, O] uint8 whose rows map to
    device-planned frames in plan order, lengths is the per-row content
    size, and host_results maps frame_idx -> bytes for frames outside the
    device envelope.  With materialize=True, returns (results, stats)
    where results is the list of all frame bytes in order (device rows
    copied out — testing convenience, not the deployment path).
    """
    import os
    import time

    import jax
    import jax.numpy as jnp

    from ..ops import device_fse as df
    from ..ops import device_huf as dh
    from ..ops.pallas_gpu import next_pow2

    prof = os.environ.get("ZT_DP_PROF")
    t_last = [time.perf_counter()]

    def tick(stage):
        if prof:
            now = time.perf_counter()
            print(f"  dp {stage}: {(now - t_last[0]) * 1e3:.0f} ms",
                  flush=True)
            t_last[0] = now

    plan = plan_batch(frames, ddict=ddict)
    tick("plan")
    host_results = {}
    if plan.host_routed:
        from .frame import decompress

        for fi in plan.host_routed:
            if ddict is not None:
                from .frame import FrameDecoder

                fd = FrameDecoder(dict_content=np.asarray(ddict.content),
                                  dict_entropy=ddict.entropy,
                                  dict_id=ddict.dict_id)
                content, _ = fd.decode(bytes(frames[fi]))
                host_results[fi] = content.tobytes()
            else:
                host_results[fi] = decompress(bytes(frames[fi]))

    if not plan.blocks and not plan.mb_frames:
        _release_ops(plan.nb, None)  # nothing was uploaded from the ctx
        if materialize:
            return [host_results[i] for i in range(plan.n_frames)], {
                "device_frames": 0, "host_frames": len(host_results),
                "devices": []}
        return [], np.zeros(0, np.int64), host_results

    # ---- stage 1: entropy kernels, one launch each for the whole batch
    # (async: nothing blocks until the exec outputs are consumed, so
    # uploads/kernels/exec pipeline through the dispatch queue) ----
    nb = plan.nb
    huf_flat = None
    huf_T = 0
    n_huf = nb.n_huf if nb is not None else len(plan.huf_payloads)
    if n_huf:
        ops = (nb.huf_ops() if nb is not None else dh.prepare_batch(
            plan.huf_payloads, plan.huf_weights, plan.huf_nsyms))
        rows = dh.decode_lanemajor(ops)              # [NL >= n_huf, T] u8
        huf_T = rows.shape[1]
        huf_flat = rows.reshape(-1)
        if prof:
            jax.block_until_ready(huf_flat)
            tick("huf")

    fse_rows = None
    fse_T = 0
    n_fse = nb.n_fse if nb is not None else len(plan.fse_payloads)
    if n_fse:
        ops = (nb.fse_ops() if nb is not None else df.prepare_batch(
            plan.fse_payloads, plan.fse_tables, plan.fse_nseqs,
            plan.fse_reps))
        fse_rows = df.decode_lanemajor(ops)          # 3 x [NL >= n_fse, T]
        fse_T = fse_rows[0].shape[1]
        if prof:
            jax.block_until_ready(fse_rows)
            tick("fse")

    # host-decoded sequence rows (fallback lanes)
    S = _bucket(max(plan.max_seq, fse_T, 1), _S_BUCKETS)
    if plan.host_seqs:
        H = next_pow2(len(plan.host_seqs), 8)
        h_ll = np.zeros((H, S), np.int32)
        h_ml = np.zeros((H, S), np.int32)
        h_of = np.zeros((H, S), np.int32)
        for r, (lls, mls, ofs) in enumerate(plan.host_seqs):
            n = len(lls)
            h_ll[r, :n] = lls
            h_ml[r, :n] = mls
            h_of[r, :n] = ofs
        h_rows = (jnp.asarray(h_ll), jnp.asarray(h_ml), jnp.asarray(h_of))
    else:
        h_rows = None

    pool = (nb.pool_array() if nb is not None
            else np.frombuffer(bytes(plan.raw_pool), np.uint8))
    raw = np.zeros(_pool_bucket(len(pool) + 1), np.uint8)
    raw[:len(pool)] = pool
    raw_flat = jnp.asarray(raw)

    # shared dictionary window (right-aligned; W=8 zero rows when absent)
    W = 8
    win_row = None
    if plan.window:
        for wb in (4096, 32768, 1 << 17):
            if len(plan.window) <= wb:
                W = wb
                break
        wr = np.zeros(W, np.uint8)
        wr[W - len(plan.window):] = np.frombuffer(plan.window, np.uint8)
        win_row = jnp.asarray(wr)

    # ---- stage 2: assemble lanes + execute, EXEC_LANES at a time ----
    O = _bucket(max(plan.max_out, 1), _O_BUCKETS)
    L = O
    outputs = []
    lengths = np.array([b.out_len for b in plan.blocks], np.int64)

    nblk = len(plan.blocks)
    B = EXEC_LANES if nblk > 64 else 64
    fused = _fused_decode(huf_T, fse_T, S, L, B, O, W)

    for c0 in range(0, nblk, B):
        chunk = plan.blocks[c0:c0 + B]
        meta = np.zeros((B, 11), np.int32)
        for k, b in enumerate(chunk):
            meta[k] = (b.lit_kind, b.pool_base, b.pool_len, b.huf_lane0,
                       b.huf_seg, b.seq_kind, b.fse_lane, b.host_row,
                       b.n_seq, b.lit_regen, b.out_len)
        outputs.append(fused(jnp.asarray(meta), huf_flat, fse_rows, h_rows,
                             raw_flat, win_row))
    if prof:
        jax.block_until_ready(outputs)
        tick("exec")

    # ---- multi-block frames: dependent execution rounds ----
    mb_device = {}
    if plan.mb_frames:
        dict_tail = np.frombuffer(plan.window, np.uint8) if plan.window \
            else None
        for group in _mb_groups(plan.mb_frames):
            F = len(group)
            Wb = _bucket(max(f["window"] for f in group), _MBW_BUCKETS)
            Cb = _bucket(max(f["content"] for f in group), _MBC_BUCKETS)
            n_rounds = max(len(f["blocks"]) for f in group)
            O_max = _bucket(
                max(b.out_len for f in group for b in f["blocks"]),
                _O_BUCKETS)
            acc = jnp.zeros((F, Wb + Cb + O_max), jnp.uint8)
            if dict_tail is not None and len(dict_tail):
                t = dict_tail[-Wb:]
                acc = acc.at[:, Wb - len(t):Wb].set(jnp.asarray(t))
            fusedm = _fused_decode(huf_T, fse_T, S, O_max, F, O_max, Wb)
            slice_win = jax.vmap(
                lambda a, st: jax.lax.dynamic_slice(a, (st,), (Wb,)))
            write_out = jax.vmap(
                lambda a, o, st: jax.lax.dynamic_update_slice(a, o, (st,)))
            for r in range(n_rounds):
                meta = np.zeros((F, 11), np.int32)
                # fresh per round: jnp.asarray may alias numpy memory on
                # the CPU backend, so a reused-and-mutated array races
                # with still-in-flight async computations
                offs_np = np.full(F, Cb, np.int32)  # default: padding tail
                for k, f in enumerate(group):
                    if r >= len(f["blocks"]):
                        continue
                    b = f["blocks"][r]
                    meta[k] = (b.lit_kind, b.pool_base, b.pool_len,
                               b.huf_lane0, b.huf_seg, b.seq_kind,
                               max(b.fse_lane, 0), max(b.host_row, 0),
                               b.n_seq, b.lit_regen, b.out_len)
                    offs_np[k] = b.out_off
                starts = jnp.asarray(offs_np)
                windows = slice_win(acc, starts)
                outs = fusedm(jnp.asarray(meta), huf_flat, fse_rows,
                              h_rows, raw_flat, windows)
                # inactive lanes write zeros past their content (harmless:
                # the region beyond a finished frame's content is padding)
                acc = write_out(acc, outs, Wb + starts)
            for k, f in enumerate(group):
                mb_device[f["frame_idx"]] = (
                    acc[k, Wb:Wb + f["content"]], f["content"], f["checksum"])
        tick("mb-exec")

    fence = [outputs[-1]] if outputs else []
    if mb_device:
        # last-planned group's accumulator fences every mb upload
        fence.append(list(mb_device.values())[-1][0])
    _release_ops(plan.nb, fence or None)

    if not materialize:
        for fi, (row, n, _cks) in mb_device.items():
            host_results[fi] = row  # device-resident uint8 [content]
        return outputs, lengths, host_results

    from ..errors import ZstdError, ZstdErrorCode
    from ..utils.xxhash import content_checksum

    results = [None] * plan.n_frames
    for fi, data in host_results.items():
        results[fi] = data
    for fi, (row, n, cks) in mb_device.items():
        data = np.asarray(row).tobytes()
        if cks >= 0 and content_checksum(data) != cks:
            raise ZstdError(ZstdErrorCode.checksum_wrong,
                            f"frame {fi}: content checksum mismatch on "
                            "device-decoded output")
        results[fi] = data
    row = 0
    for ci, out in enumerate(outputs):
        host = np.asarray(out)
        for k in range(min(EXEC_LANES, len(plan.blocks) - ci * EXEC_LANES)):
            b = plan.blocks[ci * EXEC_LANES + k]
            data = host[k, :b.out_len].tobytes()
            if b.checksum >= 0 and content_checksum(data) != b.checksum:
                raise ZstdError(ZstdErrorCode.checksum_wrong,
                                f"frame {b.frame_idx}: content checksum "
                                "mismatch on device-decoded output")
            results[b.frame_idx] = data
            row += 1
    # where the rows were decoded: the devices holding the output arrays
    held = outputs + [row for row, _, _ in mb_device.values()]
    stats = {"device_frames": len(plan.blocks) + len(plan.mb_frames),
             "host_frames": len(host_results),
             "devices": sorted({str(d) for a in held for d in a.devices()})}
    return results, stats


def _mb_groups(mb_frames, max_group: int = 16):
    """Group multi-block frames so each dependent-round batch shares one
    compiled shape (window/content buckets) and bounded memory."""
    by_key: dict = {}
    for f in mb_frames:
        key = (_bucket(f["window"], _MBW_BUCKETS),
               _bucket(f["content"], _MBC_BUCKETS))
        by_key.setdefault(key, []).append(f)
    out = []
    for fs in by_key.values():
        for i in range(0, len(fs), max_group):
            out.append(fs[i:i + max_group])
    return out


_FUSED_CACHE: dict = {}


def _fused_decode(huf_T: int, fse_T: int, S: int, L: int, B: int, O: int,
                  W: int = 8):
    """One jit-compiled dispatch: per-lane metadata + kernel outputs ->
    decoded bytes.  Gather math derives every index from header scalars
    (no per-byte host-built maps), then runs the pointer-jumping executor
    inline so assembly and execution fuse into a single XLA program."""
    key = (huf_T, fse_T, S, L, B, O, W)
    if key in _FUSED_CACHE:
        return _FUSED_CACHE[key]
    import jax
    import jax.numpy as jnp

    from ..ops.execseq import make_executor

    run_exec = make_executor(B, S, L, W, O)

    def fused(meta, huf_flat, fse_rows, h_rows, raw_flat, win_row):
        lit_kind = meta[:, 0]
        pool_base = meta[:, 1]
        pool_len = meta[:, 2]
        lane0 = meta[:, 3]
        seg = jnp.maximum(meta[:, 4], 1)
        seq_kind = meta[:, 5]
        fse_lane = jnp.maximum(meta[:, 6], 0)
        host_row = jnp.maximum(meta[:, 7], 0)
        n_seq = meta[:, 8]
        lit_regen = meta[:, 9]
        out_len = meta[:, 10]

        i = jnp.arange(L, dtype=jnp.int32)[None, :]
        # raw-pool source: per-lane contiguous span via dynamic_slice.  An
        # RLE span (pool_len 1) broadcasts its single byte.
        raw_pad = jnp.pad(raw_flat, (0, L + 8))
        lit = jax.vmap(
            lambda st: jax.lax.dynamic_slice(raw_pad, (st,), (L,)))(
            pool_base)
        lit = jnp.where(pool_len[:, None] == 1, lit[:, :1], lit)
        if huf_flat is not None:
            # each lane's 4 streams are 4 consecutive T-rows of the flat
            # kernel output: one contiguous 4T slice, then a minor-dim
            # gather stitches the quarters at their real lengths
            huf_pad = jnp.pad(huf_flat, (0, 4 * huf_T + 8))
            quads = jax.vmap(
                lambda l0: jax.lax.dynamic_slice(
                    huf_pad, (l0 * huf_T,), (4 * huf_T,)))(
                jnp.maximum(lane0, 0))
            s = jnp.minimum(i // seg[:, None], 3)
            within = i - s * seg[:, None]
            qi = jnp.clip(s * huf_T + within, 0, 4 * huf_T - 1)
            lit_huf = jnp.take_along_axis(quads, qi, axis=1).astype(jnp.uint8)
            lit = jnp.where(lit_kind[:, None] == 1, lit_huf, lit)

        def rows_from(src, idx, T):
            r = jnp.take(src, idx, axis=0)
            if T < S:
                r = jnp.pad(r, ((0, 0), (0, S - T)))
            return r[:, :S]

        zero = jnp.zeros((B, S), jnp.int32)
        ll, ml, off = zero, zero, jnp.ones_like(zero)
        if fse_rows is not None:
            m = (seq_kind == 1)[:, None]
            ll = jnp.where(m, rows_from(fse_rows[0], fse_lane, fse_T), ll)
            ml = jnp.where(m, rows_from(fse_rows[1], fse_lane, fse_T), ml)
            off = jnp.where(m, rows_from(fse_rows[2], fse_lane, fse_T), off)
        if h_rows is not None:
            m = (seq_kind == 2)[:, None]
            ll = jnp.where(m, jnp.take(h_rows[0], host_row, axis=0), ll)
            ml = jnp.where(m, jnp.take(h_rows[1], host_row, axis=0), ml)
            off = jnp.where(m, jnp.take(h_rows[2], host_row, axis=0), off)

        live = jnp.arange(S, dtype=jnp.int32)[None, :] < n_seq[:, None]
        sum_ll = jnp.sum(jnp.where(live, ll, 0), axis=1)
        last_lit = lit_regen - sum_ll
        if win_row is None:
            window = jnp.zeros((B, W), jnp.uint8)
        elif win_row.ndim == 2:
            window = win_row                      # per-lane (multi-block)
        else:
            window = jnp.broadcast_to(win_row[None, :], (B, W))
        return run_exec(lit, window, ll.astype(jnp.uint32),
                        ml.astype(jnp.uint32), off.astype(jnp.uint32),
                        n_seq, last_lit, out_len)

    fn = jax.jit(fused)
    _FUSED_CACHE[key] = fn
    return fn
