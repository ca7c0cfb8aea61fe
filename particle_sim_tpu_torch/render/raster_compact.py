"""Compaction + segmented-sort rasterizer, on two hand-written CUDA kernels.

Counterpart of ``particle_sim_tpu/render/raster_compact.py``; same frame
as raster.render (additive premultiplied blend, clamped to 1). The
pipeline, in plain PyTorch around two kernels of csrc/raster_compact.cu:

  1. shade and project every point into a key word (tile * 1024 + pixel
     inside the 8x128 tile, or the sentinel when it draws nothing) and two
     bf16-packed colour words;
  2. keep only the 512-point chunks that hold a visible point: the kept
     chunks are copied into a static bucket by the **compaction kernel**
     (:func:`compact`);
  3. sort the bucket in independent segments, and build a tile-major
     (tile, chunk) pair table with one small sort;
  4. the **deposit kernel** (:func:`deposit`) sums, for every tile, the
     points of the chunks its table entries name. Its work is split by
     table entries, not by tiles: a warp takes one 128-point group of one
     entry's chunk, reads the colour only where the entry's in-tile run
     lies, and adds each pixel's sum once to the frame, which the launch
     zeroes first.

Each kernel wrapper takes its plain PyTorch version (``compact_plain``,
``deposit_plain``) for CPU tensors, and on CUDA tensors launches the
kernel or raises. ``render(..., plain=True)`` runs the whole pipeline on
the plain versions, the reference the kernels are checked against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import cuda_build, trace
from ..utils.search import rank_right_iota
from .raster import (
    PX_PER_TILE, TILE_H, TILE_W, TileKeys, tile_keys, tiles_to_frame,
)

CHUNK = 512
SEGMENTS = 16                   # sort rows; divisor of every bucket's chunks

_S_BITS = 17                    # chunk-slice field (up to 64M points)
_S_MASK = (1 << _S_BITS) - 1
_F_BIT = 1 << _S_BITS           # first-visit (PAD) flag
_T_SHIFT = _S_BITS + 1          # tile field (13 bits: up to 8191 tiles)
_MAX_TILES = (1 << 13) - 1
_TRASH = 0x7FFFFFFF             # unused pair-table slot; sorts last

#: Kernel launches made by :func:`compact` and :func:`deposit`.
COMPACT_LAUNCHES = 0
DEPOSIT_LAUNCHES = 0


def pack_rgb_bf16(r, g, b):
    """(rg i32[N], b i32[N]): r and g as the bf16 halves of one word, b as
    bf16 in the low half of a second word. bf16 is the top 16 bits of an
    f32, rounded to nearest by adding 0x8000 before the shift. int32 ``>>``
    is arithmetic in torch, so the mask keeps the logical shift's 16 bits."""
    def bits16(v):
        raw = v.to(torch.float32).contiguous().view(torch.int32)
        return ((raw + 0x8000) >> 16) & 0xFFFF

    return bits16(r) | (bits16(g) << 16), bits16(b)


def unpack_rgb_bf16(rg, bw):
    """Inverse of :func:`pack_rgb_bf16` -> (r, g, b) f32."""
    def as_f32(hi16):
        return hi16.contiguous().view(torch.float32)

    return as_f32(rg << 16), as_f32(rg & -65536), as_f32(bw << 16)


# -- kernel 2: visibility compaction -------------------------------------------
def _check_words(names_tensors, device, n=None):
    for name, t in names_tensors:
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, expected {device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if n is not None and t.shape != (n,):
            raise ValueError(f"{name} must have shape ({n},), "
                             f"got {tuple(t.shape)}")


def compact_plain(key, rg, bw, kept_list, kept_n, *, bucket: int,
                  sentinel: int):
    """Plain version of the compaction kernel: output chunk i is input
    chunk kept_list[i] for i < kept_n, else sentinel keys and zero colour.
    -> (key, rg, b) int32[bucket]."""
    i = torch.arange(bucket // CHUNK, device=key.device)
    live = (i < kept_n)[:, None]
    src = kept_list[: bucket // CHUNK].long()

    def one(words, fill):
        chunks = words.view(-1, CHUNK)[src]
        return torch.where(live, chunks, fill).reshape(-1)

    return one(key, sentinel), one(rg, 0), one(bw, 0)


def compact(key, rg, bw, kept_list, kept_n, *, bucket: int, sentinel: int):
    """Copy the kept chunks into a bucket of ``bucket`` points (kernel 2).
    key/rg/bw: int32[n]; kept_list: int32[n/512]; kept_n: int32[1] on the
    same device (read there, never on the host)."""
    global COMPACT_LAUNCHES
    n = key.shape[0]
    if n % CHUNK or bucket % CHUNK or not 0 <= bucket <= n:
        raise ValueError(f"n={n}, bucket={bucket}: both must be multiples "
                         f"of {CHUNK} with bucket <= n")
    _check_words((("key", key), ("rg", rg), ("b", bw)), key.device, n)
    _check_words((("kept_list", kept_list),), key.device, n // CHUNK)
    _check_words((("kept_n", kept_n),), key.device, 1)
    if key.device.type == "cpu":
        return compact_plain(key, rg, bw, kept_list, kept_n, bucket=bucket,
                             sentinel=sentinel)
    if key.device.type != "cuda":
        raise ValueError(f"unsupported device {key.device}")
    for name, t in (("key", key), ("rg", rg), ("b", bw)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = [torch.empty((bucket,), dtype=torch.int32, device=key.device)
           for _ in range(3)]
    lib = cuda_build.library()
    stream = torch.cuda.current_stream(key.device).cuda_stream
    with torch.cuda.device(key.device):
        err = lib.psim_compact(
            key.data_ptr(), rg.data_ptr(), bw.data_ptr(),
            kept_list.data_ptr(), kept_n.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            bucket, sentinel, stream)
    COMPACT_LAUNCHES += 1
    cuda_build.check(err, "compact")
    return tuple(out)


# -- kernel 3: tile deposit ------------------------------------------------------
def deposit_plain(table, offsets, key_p, rg_p, b_p, *, n_tiles: int):
    """Plain version of the deposit kernel -> f32[n_tiles, 3, 8, 128].

    Every table entry without the first-visit flag names (tile, chunk);
    the chunk's points whose key lies inside that tile add their colour
    to it. The tile of an entry is read from its word, as the kernel
    reads it; the kernel visits only the entries [0, offsets[n_tiles]),
    this version every entry, so a wrong offsets[n_tiles] shows as a
    mismatch.
    """
    del offsets
    n_chunks = key_p.shape[0] // CHUNK
    keep = (table & _F_BIT) == 0          # also drops _TRASH slots
    tile = torch.where(keep, (table >> _T_SHIFT) & _MAX_TILES, 0)
    s = torch.clamp(table & _S_MASK, max=n_chunks - 1).long()
    local = key_p.view(n_chunks, CHUNK)[s] - (tile * PX_PER_TILE)[:, None]
    inside = keep[:, None] & (local >= 0) & (local < PX_PER_TILE)
    r, g, b = unpack_rgb_bf16(rg_p.view(n_chunks, CHUNK)[s],
                              b_p.view(n_chunks, CHUNK)[s])
    pix = (tile[:, None] * 3 * PX_PER_TILE
           + torch.where(inside, local, 0)).long()
    out = torch.zeros((n_tiles * 3 * PX_PER_TILE,), dtype=torch.float32,
                      device=key_p.device)
    w = inside.to(torch.float32)
    for c, v in enumerate((r, g, b)):
        out.index_add_(0, (pix + c * PX_PER_TILE).reshape(-1),
                       (v * w).reshape(-1))
    return out.view(n_tiles, 3, TILE_H, TILE_W)


def deposit(table, offsets, key_p, rg_p, b_p, *, n_tiles: int):
    """Sum each tile's table entries into tile planes (kernel 3).

    table: int32 tile-major pair-table words (tile << 18 | flag | chunk);
    offsets: int32[n_tiles + 1], tile t owns table[offsets[t]:offsets[t+1]]
    (the kernel reads offsets[n_tiles], the count of entries in use);
    key_p, rg_p, b_p: int32[n_chunks * 512] chunk words.
    -> f32[n_tiles, 3, 8, 128]."""
    global DEPOSIT_LAUNCHES
    m = key_p.shape[0]
    if m % CHUNK or not 0 < m // CHUNK <= _S_MASK + 1:
        raise ValueError(f"{m} points: need a multiple of {CHUNK} and at "
                         f"most {(_S_MASK + 1) * CHUNK}")
    if not 0 < n_tiles <= _MAX_TILES:
        raise ValueError(f"n_tiles={n_tiles} outside 1..{_MAX_TILES}")
    if table.ndim != 1:
        raise ValueError("table must be 1-D")
    _check_words((("table", table),), key_p.device)
    _check_words((("offsets", offsets),), key_p.device, n_tiles + 1)
    _check_words((("key", key_p), ("rg", rg_p), ("b", b_p)), key_p.device, m)
    if key_p.device.type == "cpu":
        return deposit_plain(table, offsets, key_p, rg_p, b_p,
                             n_tiles=n_tiles)
    if key_p.device.type != "cuda":
        raise ValueError(f"unsupported device {key_p.device}")
    out = torch.empty((n_tiles, 3, TILE_H, TILE_W), dtype=torch.float32,
                      device=key_p.device)
    lib = cuda_build.library()
    stream = torch.cuda.current_stream(key_p.device).cuda_stream
    with torch.cuda.device(key_p.device):
        err = lib.psim_deposit(
            table.data_ptr(), offsets.data_ptr(), key_p.data_ptr(),
            rg_p.data_ptr(), b_p.data_ptr(), out.data_ptr(), n_tiles,
            m // CHUNK, table.shape[0], stream)
    DEPOSIT_LAUNCHES += 1
    cuda_build.check(err, "deposit")
    return out


# -- the plain pipeline around the kernels ----------------------------------------
class PointWords(NamedTuple):
    """Per-point words of one frame, and the chunk visibility."""

    key: torch.Tensor        # int32[n]
    rg: torch.Tensor         # int32[n]
    b: torch.Tensor          # int32[n]
    kept_list: torch.Tensor  # int32[n/512]: visible chunks first, in order
    kept_n: torch.Tensor     # int32[1]: number of visible chunks
    n_tiles: int
    sentinel: int


def point_words(pos, vel, init_color, param_vec, view_proj, n_active, *,
                width: int, height: int) -> PointWords:
    """Shade, project and pack every point; list the visible chunks."""
    return words_of(tile_keys(pos, vel, init_color, param_vec, view_proj,
                              n_active, width=width, height=height))


def words_of(keys: TileKeys) -> PointWords:
    """Pack the colour of one frame's tile keys into bf16 words and list
    the visible chunks."""
    if keys.n_tiles > _MAX_TILES:
        raise ValueError(f"{keys.n_tiles} framebuffer tiles; at most "
                         f"{_MAX_TILES}")
    if keys.key.shape[0] % CHUNK:
        raise ValueError(f"point count {keys.key.shape[0]} not a multiple "
                         f"of {CHUNK}")
    key, sentinel = keys.key, keys.sentinel
    rg_w, b_w = pack_rgb_bf16(keys.r, keys.g, keys.b)

    # chunk-granular visibility: kept-chunk list via a stable sort
    # (visible chunks first, original order preserved)
    vis = (key.view(-1, CHUNK).amin(dim=1) < sentinel).to(torch.int32)
    kept_n = vis.sum().to(torch.int32).reshape(1)
    kept_list = torch.sort(1 - vis, stable=True).indices.to(torch.int32)
    return PointWords(key, rg_w, b_w, kept_list, kept_n, keys.n_tiles,
                      sentinel)


def segments_for(b: int) -> int:
    s = SEGMENTS
    while s > 1 and (b % (s * CHUNK) or b // CHUNK < 2 * s):
        s //= 2
    return s


def buckets(n: int) -> list:
    """Ascending static compaction sizes. The largest is always n; smaller
    ones are SEGMENTS*CHUNK-aligned halvings down to n/8."""
    out = [n]
    step = SEGMENTS * CHUNK
    b = n // 2
    while b >= max(step, n // 8):
        out.append(-(-b // step) * step)
        b //= 2
    return sorted(set(out))


class PairTable(NamedTuple):
    """Inputs of the deposit kernel."""

    table: torch.Tensor      # int32[c_real + n_tiles], tile-major
    offsets: torch.Tensor    # int32[n_tiles + 1]
    key: torch.Tensor        # int32[b + 512]: segment-sorted + PAD chunk
    rg: torch.Tensor
    b: torch.Tensor


def pair_table(key_c, rg_c, b_c, *, n_tiles: int, sentinel: int
               ) -> PairTable:
    """Segment-sort a compacted bucket and build its tile-major table."""
    bsz = key_c.shape[0]
    n_chunks = bsz // CHUNK
    seg = segments_for(bsz)
    dev = key_c.device

    key_s, order = torch.sort(key_c.view(seg, bsz // seg), dim=1)
    rg_s = torch.gather(rg_c.view(seg, -1), 1, order).reshape(-1)
    b_s = torch.gather(b_c.view(seg, -1), 1, order).reshape(-1)
    key_s = key_s.reshape(-1)

    # per-chunk tile range over live keys (chunks are slices of a sorted
    # segment, so keys are sorted within each chunk; sentinels sit at the
    # end of each segment and are masked out of the range)
    kc = key_s.view(n_chunks, CHUNK)
    live = kc < sentinel
    t_first = torch.where(live, kc >> 10, n_tiles).amin(dim=1)
    t_last = torch.where(live, kc >> 10, -1).amax(dim=1)
    cnt = torch.clamp_min(t_last - t_first + 1, 0)        # 0 = empty chunk
    total_real = cnt.sum()

    # candidate pairs, chunk-major: chunk s x tiles [t_first_s, t_last_s];
    # per segment the total telescopes to <= its chunks + n_tiles
    c_real = n_chunks + seg * n_tiles
    base = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                      torch.cumsum(cnt, 0, dtype=torch.int32)])
    kk = torch.arange(c_real, dtype=torch.int32, device=dev)
    s_k = torch.clamp(rank_right_iota(base, c_real), 0, n_chunks - 1).long()
    real = kk < total_real
    t_k = torch.clamp(t_first[s_k] + (kk - base[s_k]), 0, n_tiles - 1)
    word_r = torch.where(real, s_k.to(torch.int32) | (t_k << _T_SHIFT), _TRASH)
    sort_r = torch.where(real, t_k * 2 + 1, _TRASH)

    # PAD pairs: every tile's first visit, pointing at the all-sentinel
    # PAD chunk appended below; sorts BEFORE the tile's real pairs
    t_pad = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    word_p = n_chunks | _F_BIT | (t_pad << _T_SHIFT)
    sort_p = t_pad * 2

    sort_keys, perm = torch.sort(torch.cat([sort_p, sort_r.to(torch.int32)]))
    table = torch.cat([word_p, word_r.to(torch.int32)])[perm]
    probes = torch.arange(0, 2 * n_tiles + 1, 2, dtype=torch.int32,
                          device=dev)
    offsets = torch.searchsorted(sort_keys, probes, out_int32=True)

    pad_key = torch.full((CHUNK,), sentinel, dtype=torch.int32, device=dev)
    pad_zero = torch.zeros((CHUNK,), dtype=torch.int32, device=dev)
    return PairTable(table, offsets, torch.cat([key_s, pad_key]),
                     torch.cat([rg_s, pad_zero]), torch.cat([b_s, pad_zero]))


def render_tiles(words: PointWords, *, plain: bool = False) -> torch.Tensor:
    """Compact -> segment-sort -> pair table -> deposit.
    -> f32[n_tiles, 3, 8, 128] tile planes."""
    n = words.key.shape[0]
    # The bucket is chosen from kept_n on the host: eager PyTorch has no
    # traced switch, so this is one device->host read per rendered frame
    # (never per simulation step).
    with trace.span("render.kept_read"):
        kept_points = int(words.kept_n.item()) * CHUNK
    bsz = next(bb for bb in buckets(n) if kept_points <= bb)
    do_compact, do_deposit = ((compact_plain, deposit_plain) if plain
                              else (compact, deposit))
    key_c, rg_c, b_c = do_compact(words.key, words.rg, words.b,
                                  words.kept_list, words.kept_n,
                                  bucket=bsz, sentinel=words.sentinel)
    pt = pair_table(key_c, rg_c, b_c, n_tiles=words.n_tiles,
                    sentinel=words.sentinel)
    return do_deposit(pt.table, pt.offsets, pt.key, pt.rg, pt.b,
                      n_tiles=words.n_tiles)


def render(
    pos: torch.Tensor, vel: torch.Tensor, init_color: torch.Tensor,
    param_vec: torch.Tensor, view_proj: torch.Tensor, n_active: torch.Tensor,
    *, width: int = 1920, height: int = 1080, plain: bool = False,
) -> torch.Tensor:
    """f32[height, width, 3] framebuffer in [0, 1].

    Same semantics as raster.render; width/height must be multiples of
    128/8 and the point capacity a multiple of 512. Works on any point
    order; the compaction only shrinks the work when invisible points
    come in whole chunks (the generation order does). ``plain=True`` runs
    the plain versions of both kernels on any device.
    """
    words = point_words(pos, vel, init_color, param_vec, view_proj,
                        n_active, width=width, height=height)
    return tiles_to_frame(render_tiles(words, plain=plain), width, height)
