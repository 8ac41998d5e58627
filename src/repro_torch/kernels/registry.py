"""Legal-geometry registry for the port's Hopper kernels and serving pool.

The counterpart of the reference's ``kernels/registry.py``: the one place
that declares, for the auto-tuner (``repro_torch.tuning``) and the
rc3e-check kernel pass (``repro_torch.analysis.kernelpass``),

  * the card: an H100 SXM's SMs, shared memory, registers and HBM, and its
    peak rates (the cost model's ceilings);
  * what the CUDA kernels take: their compiled tiles, the head dims and
    state dims they are built for, the query heads a decode block holds
    (any group runs: a bf16 group past one chunk on the group kernel,
    ``decode_route`` / ``decode_group_plan``; others in chunks of the
    split kernel), the split-K constants, and each kernel's shared memory
    a block at every head dim and state dim it is built for;
  * the axes the tuner may sweep (page size, decode slots, prefill chunk)
    with their legal ranges and defaults;
  * the divisibility and fit rules, each returning ``None`` when legal,
    else a reason (the tuner prunes on it; the analysis pass fails on it).

The kernel modules keep their own constants (``decode_attention.HEAD_DIMS``,
``mamba2_chunk.STATE_DIMS``, ``stream_matmul.MM_TILE``, ...) and the CUDA
sources their ``constexpr`` tiles; tests pin those to the values here. No
kernel tile is a sweep axis: the tiles are compiled constants, and
``split_plan`` derives the split count from the live shape and the SM count.

Pure Python: importing it builds and touches nothing.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

# ---------------------------------------------------------------------------
# The card: NVIDIA H100 SXM5 80 GB (compute capability 9.0)
# ---------------------------------------------------------------------------
SM_COUNT = 132
SMEM_PER_BLOCK = 227 * 1024          # opt-in dynamic shared memory a block
SMEM_PER_SM = 228 * 1024
STATIC_SMEM_PER_BLOCK = 48 * 1024    # static __shared__ arrays a block
REGS_PER_SM = 64 * 1024
REGS_PER_THREAD = 255
HBM_BYTES = 80 * 1024 ** 3
HBM_BW = 3.35e12                     # bytes/s
PEAK_FLOPS: Dict[str, float] = {     # dense, per second
    "bfloat16": 989e12,              # tensor cores
    "tf32": 495e12,                  # tensor cores
    "float32": 67e12,                # CUDA cores
}

# ---------------------------------------------------------------------------
# What the kernels take
# ---------------------------------------------------------------------------
# the attention kernels' head dims; another multiple of HEAD_ALIGN up to
# the largest runs on the next of them: zero-padded up to
# MAX_PADDED_HEAD_DIM (kExactMaxD), read in place (its tail masked) above
HEAD_DIMS: Tuple[int, ...] = (32, 64, 96, 112, 128, 256, 384, 512)
HEAD_ALIGN = 8
MAX_PADDED_HEAD_DIM = 256
CHUNK_HEADS = 8                      # query heads a decode block holds
WIDE_CHUNK_HEADS = 4                 # the same past MAX_PADDED_HEAD_DIM
STATE_DIMS: Tuple[int, ...] = (16, 64, 128)   # the SSD's d_state

# split-K decode (decode_attention.split_plan)
MIN_SPLIT_ROWS = 64
GROUP_MIN_SPLIT_ROWS = 32            # the same on the group kernel's route
SPLIT_WAVES = 2
MAX_SPLITS = 128

# compiled tiles (csrc/*.cu constexprs)
DECODE_WARPS = 8                     # warps of a split block (kWarps)
DECODE_LOADS = 2                     # row loads a lane an iteration (kLoads)
DECODE_GROUPS: Tuple[int, ...] = (4, 8)   # G the split kernel is built for
                                          # (WIDE_CHUNK_HEADS past 256)
DECODE_MERGE_THREADS = 256           # kMergeThreads
GROUP_WARPS = 8                      # warps of a group block at most
                                     # (kGroupWarps)
GROUP_KV_DTYPES: Tuple[str, ...] = ("bfloat16", "int8")   # its K/V builds
FLASH_BQ = 64                        # query rows a block
FLASH_STAGES = 2                     # groups of K/V tiles in flight
MM_TILE = 128                        # 2-D matmul output tile (kMmBM/kMmBN)
MM_BK: Dict[str, int] = {"float32": 16, "bfloat16": 64}
MM_STAGES: Dict[str, int] = {"float32": 4, "bfloat16": 3}
MM_BATCHED_TILE = 64                 # batched tiled kernel (BM = BN)
MM_BATCHED_BK = 16
SSD_CHUNK = 32                       # steps a chunk (kChunk)

# ---------------------------------------------------------------------------
# The sweep axes: legal ranges and the defaults that shipped before the tuner
# ---------------------------------------------------------------------------
PAGE_SIZE_DEFAULT = 16
SLOTS_DEFAULT = 4
PREFILL_CHUNK_DEFAULT = 4
PAGE_SIZE_CHOICES: Tuple[int, ...] = (8, 16, 32, 64)
SLOTS_CHOICES: Tuple[int, ...] = (2, 4, 8)
PREFILL_CHUNK_CHOICES: Tuple[int, ...] = (2, 4, 8, 16)


def dtype_bytes(dtype: str) -> int:
    if "int8" in dtype:
        return 1
    if "bfloat16" in dtype or "float16" in dtype:
        return 2
    if "float64" in dtype or "int64" in dtype:
        return 8
    return 4


# ---------------------------------------------------------------------------
# Divisibility and range rules
# ---------------------------------------------------------------------------

def padded_head_dim(head_dim: int) -> Optional[int]:
    """The head dim the attention kernels run ``head_dim`` at: itself when
    it is in ``HEAD_DIMS``, the next member for another multiple of
    ``HEAD_ALIGN`` up to the largest, else ``None`` (no kernel takes it)."""
    if head_dim in HEAD_DIMS:
        return head_dim
    if head_dim % HEAD_ALIGN or head_dim > HEAD_DIMS[-1] or head_dim < 1:
        return None
    return next(d for d in HEAD_DIMS if d > head_dim)


def check_head_dim(head_dim: int) -> Optional[str]:
    """The wrappers' own refusal: a multiple of ``HEAD_ALIGN`` up to the
    largest of ``HEAD_DIMS``."""
    if padded_head_dim(head_dim) is None:
        return (f"head_dim={head_dim} is refused: the attention kernels "
                f"take a multiple of {HEAD_ALIGN} up to {HEAD_DIMS[-1]} "
                f"(built for {HEAD_DIMS})")
    return None


def check_group(n_heads: int, n_kv_heads: int) -> Optional[str]:
    """Any group of query heads a kv head: decode runs a bf16 group past
    one chunk of ``CHUNK_HEADS`` (``WIDE_CHUNK_HEADS`` past
    ``MAX_PADDED_HEAD_DIM``) on the group kernel (``decode_route``), an
    fp32 one in chunks of the split kernel; the heads must divide."""
    if n_kv_heads < 1 or n_heads % n_kv_heads:
        return f"n_heads={n_heads} not a multiple of n_kv_heads={n_kv_heads}"
    return None


def decode_groups(head_dim: int) -> Tuple[int, ...]:
    """The G the split kernel is built for at ``head_dim`` (the chunked
    route: every group of one chunk, and fp32 past it)."""
    return DECODE_GROUPS if head_dim <= MAX_PADDED_HEAD_DIM \
        else (WIDE_CHUNK_HEADS,)


def decode_route(group: int, head_dim: int, dtype: str) -> str:
    """Which split kernel a decode launch takes, from shapes and dtype
    alone: ``"group"`` (``decode_group_kernel``) for bf16 q whose group
    would run in more than one chunk (past ``CHUNK_HEADS``, or past
    ``WIDE_CHUNK_HEADS`` at a head dim past ``MAX_PADDED_HEAD_DIM``),
    else ``"split"`` (``decode_split_kernel``: every group of one chunk,
    and fp32 q, whose tolerance a bf16 product would break)."""
    most = CHUNK_HEADS if head_dim <= MAX_PADDED_HEAD_DIM \
        else WIDE_CHUNK_HEADS
    return "group" if dtype == "bfloat16" and group > most else "split"


class GroupPlan(NamedTuple):
    """How the group kernel cuts a kv head's group of query heads: blocks
    of ``m`` query rows (whole 16-row m-tiles; the group zero-padded) in
    ``n_slices`` slices, K/V staged in tiles of ``rows`` rows,
    ``stages`` deep; ``key_groups`` warps split a tile's 16-key steps,
    ``col_groups`` split O's columns, ``warps`` = key_groups x m-tiles x
    col_groups."""
    m: int
    n_slices: int
    rows: int
    stages: int
    key_groups: int
    col_groups: int
    warps: int


def group_tiles(head_dim: int) -> Tuple[int, int, int]:
    """(rows a staged K/V tile, stages, O column groups) of the group
    kernel's build at ``head_dim`` (``GroupCfg``): 64 rows and 3 stages up
    to 128, 32 rows past it, 2 stages past 256; O's columns in groups of
    128 past 128."""
    return (64 if head_dim <= 128 else 32, 3 if head_dim <= 256 else 2,
            1 if head_dim <= 128 else head_dim // 128)


def decode_group_plan(group: int, head_dim: int) -> GroupPlan:
    """The group kernel's plan for ``group`` query heads a kv head at
    ``head_dim`` (run at ``padded_head_dim``): as many 16-row m-tiles a
    block as ``GROUP_WARPS`` warps hold with their O columns (8 / column
    groups), the group cut into the fewest equal slices that allows, and
    the warps left over splitting the tile's keys (a power of two)."""
    hd = padded_head_dim(head_dim) or head_dim
    rows, stages, cg = group_tiles(hd)
    tiles = -(-group // 16)
    n_slices = -(-tiles // (GROUP_WARPS // cg))
    mt = -(-tiles // n_slices)
    kg = 1
    while 2 * kg <= rows // 16 and 2 * kg * mt * cg <= GROUP_WARPS:
        kg *= 2
    return GroupPlan(m=16 * mt, n_slices=n_slices, rows=rows, stages=stages,
                     key_groups=kg, col_groups=cg, warps=kg * mt * cg)


def check_state_dim(d_state: int) -> Optional[str]:
    if d_state not in STATE_DIMS:
        return f"d_state={d_state} not in {STATE_DIMS}"
    return None


def check_page_size(max_len: int, page_size: int) -> Optional[str]:
    """The paged pool carves max_len into whole pages; the engine raises
    unless ``max_len % page_size == 0`` (runtime/serve.py)."""
    if page_size < 1:
        return f"page_size={page_size} < 1"
    if max_len % page_size != 0:
        return f"max_len={max_len} not divisible by page_size={page_size}"
    return None


def check_slots(max_len: int, n_slots: int) -> Optional[str]:
    if n_slots < 1:
        return f"n_slots={n_slots} < 1"
    if n_slots > max_len:
        return f"n_slots={n_slots} > max_len={max_len}"
    return None


def check_prefill_chunk(prefill_chunk: int) -> Optional[str]:
    if prefill_chunk < 1:
        return f"prefill_chunk={prefill_chunk} < 1"
    return None


# ---------------------------------------------------------------------------
# Shared memory a block (bytes), mirroring each kernel's arrays
# ---------------------------------------------------------------------------

def _lanes_a_row(head_dim: int, kv_dtype: str) -> int:
    """Lanes that read one K/V row in decode (``Row<KT, D>::kLpr``)."""
    per = 4 if dtype_bytes(kv_dtype) == 4 else 8     # elements a vector
    n = head_dim // per
    lanes = 1
    while lanes < min(n, 32):
        lanes *= 2
    return lanes


def decode_split_smem_bytes(head_dim: int, group: int) -> int:
    """``decode_split_kernel``'s static arrays at its G ``group``: the
    warps' (m, l) and acc buffer of kBuf warps (all kWarps while their acc
    fits 32 KB, else half), whose storage also holds an idle slot's
    per-warp V sums (kWarps x D)."""
    acc = DECODE_WARPS * group * head_dim * 4
    buf = DECODE_WARPS if acc <= 32768 else DECODE_WARPS // 2
    return 4 * (max(DECODE_WARPS * head_dim, buf * group * head_dim)
                + 2 * buf * group)


def decode_merge_smem_bytes(head_dim: int, kv_dtype: str) -> int:
    """``decode_merge_kernel``'s static array: split weights (CHUNK_HEADS
    x MAX_SPLITS), the heads' maxima (padded to 32 floats), and the V row
    sums of one pass."""
    rows = DECODE_MERGE_THREADS // _lanes_a_row(head_dim, kv_dtype)
    return 4 * (CHUNK_HEADS * MAX_SPLITS + 32 + rows * head_dim)


def group_max_m(head_dim: int) -> int:
    """The most query rows a group block holds at a build (``kMaxM``)."""
    return 16 * (GROUP_WARPS // group_tiles(head_dim)[2])


def decode_group_smem_bytes(head_dim: int, kv_dtype: str, m: int) -> int:
    """Dynamic shared memory of a ``decode_group_kernel`` block of ``m``
    query rows at the build ``head_dim`` (``GroupCfg::smem``): Q (m bf16
    rows), the K/V stages, and per stage each row's page, row and flags;
    int8 adds the bf16 tiles its rows are converted into and the stages'
    row scales. bf16 rows are swizzled, padded to a multiple of 64
    elements (32 at D 32); int8 rows are staged raw (D bytes)."""
    rows, stages, _ = group_tiles(head_dim)
    ld = 32 if head_dim <= 32 else -(-head_dim // 64) * 64
    q8 = kv_dtype == "int8"
    raw = head_dim if q8 else 2 * ld
    fixed = (stages * 2 * rows * raw + stages * 3 * rows * 4
             + (2 * rows * ld * 2 + stages * 2 * rows * 4 if q8 else 0))
    return m * ld * 2 + fixed


def flash_smem_bytes(head_dim: int, dtype: str) -> int:
    """Dynamic shared memory of a flash block: the Q tile and
    ``FLASH_STAGES`` x sets K and V tiles. bf16 (``MmaCfg``): tiles of 64
    keys (32 at D >= 256), two sets (one past 256), rows padded to a
    multiple of 64 elements (32 at D 32); fp32 3xTF32 (``Tf32Cfg``): tiles
    of 64 keys at D <= 64, 32 up to 256, 16 past it, one set from D 256,
    a 32-query tile past 256, rows of D + 4 floats."""
    wide = head_dim > MAX_PADDED_HEAD_DIM
    if dtype == "bfloat16":
        bk, sets = (32 if head_dim >= 256 else 64), (1 if wide else 2)
        ld = 32 if head_dim <= 32 else -(-head_dim // 64) * 64
        return (FLASH_BQ + 2 * FLASH_STAGES * sets * bk) * ld * 2
    bk = 64 if head_dim <= 64 else 16 if wide else 32
    sets = 1 if head_dim >= 256 else 2
    bq = FLASH_BQ // 2 if wide else FLASH_BQ
    return (bq + 2 * FLASH_STAGES * sets * bk) * (head_dim + 4) * 4


def matmul_smem_bytes(dtype: str) -> int:
    """Dynamic shared memory of a 2-D ``mm_kernel`` block (``MmCfg``):
    ``MM_STAGES`` A and B k tiles; fp32 adds its two split (hi, lo) tiles."""
    bk, stages = MM_BK[dtype], MM_STAGES[dtype]
    stage = 2 * MM_TILE * bk * dtype_bytes(dtype)
    if dtype == "bfloat16":
        return stages * stage
    split = (MM_TILE * (bk // 2 + 4) + bk // 2 * (MM_TILE + 2)) * 16
    return stages * stage + 2 * split


def matmul_batched_smem_bytes(size: int) -> int:
    """Static arrays of the batched entry: ``small_batched_kernel`` at S 16
    or 32 (256 threads, 4 x 4 outputs a thread), else ``tiled_kernel``."""
    if size in (16, 32):
        mats = 256 // ((size // 4) ** 2)
        return 4 * (mats * size * (size + 1) + mats * size * size)
    return 4 * MM_BATCHED_BK * (MM_BATCHED_TILE + 4 + MM_BATCHED_TILE)


def ssd_smem_bytes(d_state: int, dtype: str, wp: int, ns: int) -> int:
    """Dynamic shared memory of an ``ssd_chunk_kernel`` block (``SsdCfg``):
    two stages of x, B, C, C B^T and the decay vectors, and the y tiles."""
    el = dtype_bytes(dtype)
    e = 16 // el
    q, pt = SSD_CHUNK, 16 * wp
    stage = (q * (pt + e) * el + q * (d_state + e) * el
             + q * (d_state + 8) * el + q * (q + 8) * 4 + 4 * q * 4)
    return 2 * stage + ns * q * (pt + 4) * 4


def ssd_blocks(d_state: int) -> Tuple[Tuple[int, int], ...]:
    """The (wp, ns) block shapes the SSD is built for at ``d_state``: 64
    rows of 4 x 2 warps, and 16 rows of 1 x 8 warps (1 x 2 at N 16)."""
    return ((4, 2), (1, 8 if d_state >= 64 else 2))


def ssd_prep_smem_bytes(d_state: int, dtype: str) -> int:
    """``ssd_prep_kernel``: a chunk's C and B rows."""
    return 2 * SSD_CHUNK * (d_state + 8) * dtype_bytes(dtype)


def kernel_footprints() -> Dict[str, int]:
    """Shared memory a block of every kernel instantiation the sources
    build, keyed ``kernel/variant``: decode at each head dim and group (and
    its merge at each K/V dtype), the group kernel at each head dim and
    K/V dtype (its largest block), flash at each head dim and dtype, the 2-D
    matmul per dtype, the batched entry per shape, the SSD at each state
    dim, dtype and block shape."""
    out: Dict[str, int] = {}
    for d in HEAD_DIMS:
        for g in decode_groups(d):
            out[f"decode_split/D{d}/G{g}"] = decode_split_smem_bytes(d, g)
        for kv in ("float32", "bfloat16", "int8"):
            out[f"decode_merge/D{d}/{kv}"] = decode_merge_smem_bytes(d, kv)
        for kv in GROUP_KV_DTYPES:
            out[f"decode_group/D{d}/{kv}"] = decode_group_smem_bytes(
                d, kv, group_max_m(d))
        for dt in ("float32", "bfloat16"):
            out[f"flash/D{d}/{dt}"] = flash_smem_bytes(d, dt)
    for dt in ("float32", "bfloat16"):
        out[f"mm/{dt}"] = matmul_smem_bytes(dt)
        for n in STATE_DIMS:
            out[f"ssd_prep/N{n}/{dt}"] = ssd_prep_smem_bytes(n, dt)
            for wp, ns in ssd_blocks(n):
                out[f"ssd/N{n}/{dt}/{wp}x{ns}"] = ssd_smem_bytes(n, dt, wp, ns)
    for s in (16, 32, 64):
        out[f"mm_batched/S{s}"] = matmul_batched_smem_bytes(s)
    return out


def check_smem(name: str, nbytes: int) -> Optional[str]:
    """A block's shared memory against the card: static arrays (the decode
    split and merge kernels, the batched kernels) within 48 KB, dynamic
    within the opt-in 227 KB."""
    static = name.startswith(("decode_split", "decode_merge", "mm_batched"))
    limit = STATIC_SMEM_PER_BLOCK if static else SMEM_PER_BLOCK
    if nbytes > limit:
        return (f"{name}: {nbytes} bytes of "
                f"{'static' if static else 'dynamic'} shared memory > "
                f"{limit}")
    return None
