"""The decode group kernel's plan, route and pass model on the CPU.

A bf16 decode launch whose group of query heads a kv head would run in
more than one chunk of the split kernel takes ``decode_group_kernel``
(``registry.decode_route``): all of a kv head's query heads (or M-row
slices of them, ``registry.decode_group_plan``) scored on the tensor cores
over K/V tiles staged once in shared memory. Held here:

* the plan covers every query head of every group exactly once, within
  the card's shared memory, the kernel's warps and an accumulator of at
  most 64 fp32 registers a lane for O (plus 8 for a 16-key step of S);
* the route sends the ten configs' groups, and every fp32 launch, to the
  split kernel and every bf16 multi-chunk group to the group kernel; the
  split plan on that route gives at least ``SPLIT_WAVES`` blocks an SM at
  ``chip_smoke.py``'s ``WIDE_GROUPS`` shapes;
* the pass model of the group kernel (``decode_group_partials_ref``: its
  tiles, key groups, bf16 roundings of Q, K, V and P, and scale folds),
  merged by ``merge_partials_ref``, against the JAX package's decode
  (``repro.kernels.ref`` and the Pallas kernel in interpret mode) at
  groups 16, 48 and 71: dense and paged (pages of 4, 8, 16 and 12, null
  pages), a window, int8 K/V, an idle slot, a row with no valid key, and
  the log-sum-exp.

The CUDA kernel is held against this model and the plain version on the
card (tests/test_torch_cuda.py, ``test_decode_group_kernel_on_card``).

Tolerance: atol 2e-2, rtol 2e-2 (bf16: P is rounded to bf16 before P·V, as
the kernel does); the log-sum-exp, which sees no bf16 rounding of P, atol
1e-3, rtol 1e-5.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import registry as kreg

torch.set_num_threads(1)

TOL = dict(atol=2e-2, rtol=2e-2)
LSE_TOL = dict(atol=1e-3, rtol=1e-5)
GROUPS = (9, 12, 16, 32, 48, 64, 71, 128)
DIMS = (32, 64, 96, 112, 128, 256, 264, 384, 512)
# chip_smoke.py's WIDE_GROUPS: (Hq, Hkv, D)
WIDE_GROUPS = ((64, 4, 128), (128, 8, 128), (71, 1, 64), (48, 1, 128))
CSRC = Path(tda.__file__).resolve().parent / "csrc"
O_REGS = 64          # fp32 accumulator registers a lane for a warp's O
S_REGS = 8           # a 16-key step of S: two n8 fragments


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("g", GROUPS)
def test_group_plan_covers_every_head_once(g, d):
    p = kreg.decode_group_plan(g, d)
    hd = kreg.padded_head_dim(d)
    assert p.m % 16 == 0 and p.n_slices >= 1
    cover = [h for s in range(p.n_slices)
             for h in range(s * p.m, min(g, (s + 1) * p.m))]
    assert cover == list(range(g))
    assert all(s * p.m < g for s in range(p.n_slices))   # no empty slice
    # warps: key groups x m-tiles x column groups, within the block
    assert p.warps == p.key_groups * (p.m // 16) * p.col_groups
    assert p.warps <= kreg.GROUP_WARPS
    assert p.key_groups & (p.key_groups - 1) == 0
    assert (p.rows // 16) % p.key_groups == 0
    # a row of the tile a thread for the row info; an idle slot's V
    # columns over the threads (at most ceil(D / 128) a thread)
    assert p.warps * 32 >= p.rows
    assert p.warps * 32 * -(-hd // 128) >= hd
    # registers: O's columns a warp, and a 16-key step of S
    assert (hd // p.col_groups) // 2 <= O_REGS
    assert (hd // p.col_groups) % 16 == 0 and hd % 16 == 0
    for kv in kreg.GROUP_KV_DTYPES:
        smem = kreg.decode_group_smem_bytes(hd, kv, p.m)
        assert smem <= kreg.SMEM_PER_BLOCK
        assert p.m <= kreg.group_max_m(hd)
        # the key groups' merge fits in the drained K/V (and int8) tiles
        rows, stages, _ = kreg.group_tiles(hd)
        ld = 32 if hd <= 32 else -(-hd // 64) * 64
        tiles = stages * 2 * rows * (hd if kv == "int8" else 2 * ld) + (
            2 * rows * ld * 2 if kv == "int8" else 0)
        handed = (p.key_groups - 1) * (p.m // 16) * p.col_groups
        assert handed * 32 * (4 + (hd // p.col_groups) // 2) * 4 <= tiles
    # as few slices as the warps allow: the m-tiles over one slice fewer
    # would not fit beside the column groups
    if p.n_slices > 1:
        tiles = -(-g // 16)
        assert -(-tiles // (p.n_slices - 1)) * p.col_groups > \
            kreg.GROUP_WARPS


def test_group_footprints_in_the_registry():
    """Every build of the group kernel (each head dim, bf16 and int8 K/V)
    is in ``kernel_footprints`` at its largest block, counted against the
    opt-in dynamic limit, not the static one."""
    fp = kreg.kernel_footprints()
    for d in kreg.HEAD_DIMS:
        for kv in kreg.GROUP_KV_DTYPES:
            key = f"decode_group/D{d}/{kv}"
            assert fp[key] == kreg.decode_group_smem_bytes(
                d, kv, kreg.group_max_m(d))
            assert fp[key] > kreg.STATIC_SMEM_PER_BLOCK or d <= 64
            assert kreg.check_smem(key, fp[key]) is None
    assert fp["decode_group/D512/int8"] == 32 * 512 * 2 + (
        2 * 2 * 32 * 512 + 2 * 3 * 32 * 4 + 2 * 32 * 512 * 2 + 2 * 2 * 32 * 4)


def test_group_constants_pinned_to_the_source_and_wrapper():
    src = (CSRC / "decode_attention.cu").read_text()
    assert int(re.search(r"^constexpr int kGroupWarps = (\d+);", src,
                         flags=re.M).group(1)) == kreg.GROUP_WARPS
    assert tda.GROUP_MIN_SPLIT_ROWS == kreg.GROUP_MIN_SPLIT_ROWS
    assert '#include "tensor_core.cuh"' in src
    for name in ("cp_async16", "ldmatrix_x4", "mma_bf16", "pack_bf16"):
        defs = [p.name for p in CSRC.iterdir()
                if re.search(rf"void {name}\(|uint32_t {name}\(",
                             p.read_text())]
        assert "decode_attention.cu" not in defs, name


# ---------------------------------------------------------------------------
# The route and the split plan
# ---------------------------------------------------------------------------

def test_route_keeps_the_ten_configs_on_the_split_kernel():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        g = cfg.n_heads // cfg.n_kv_heads
        for dt in ("bfloat16", "float32"):
            assert kreg.decode_route(g, cfg.resolved_head_dim, dt) == \
                "split", arch
        assert not tda.uses_group_kernel(g, cfg.resolved_head_dim,
                                         torch.bfloat16), arch


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("g", (1, 3, 4, 5, 8) + GROUPS)
def test_route_sends_multi_chunk_bf16_groups_to_the_group_kernel(g, d):
    chunks = tda.head_chunks(g, d)[1]
    assert tda.uses_group_kernel(g, d, torch.bfloat16) == (chunks > 1)
    assert not tda.uses_group_kernel(g, d, torch.float32)   # fp32 tolerance
    n_split, rows, plan = tda.launch_plan(2, 1, g, d, torch.bfloat16, 640,
                                          132)
    assert (plan is not None) == (chunks > 1)
    if plan is None:
        assert (n_split, rows) == tda.split_plan(2 * chunks, 640, 132)
    else:
        assert plan == kreg.decode_group_plan(g, d)
        assert (n_split, rows) == tda.split_plan(
            2 * plan.n_slices, 640, 132, unit=1,
            min_rows=tda.GROUP_MIN_SPLIT_ROWS)


@pytest.mark.parametrize("hq,hkv,d", WIDE_GROUPS)
@pytest.mark.parametrize("page", [0, 16])
def test_group_split_plan_fills_the_card(hq, hkv, d, page):
    """At B 8 and L 2048 on the H100's 132 SMs the group route launches at
    least SPLIT_WAVES blocks an SM, dense and paged, and reads each valid
    row once a kv head (one slice)."""
    n_split, rows, plan = tda.launch_plan(8, hkv, hq // hkv, d,
                                          torch.bfloat16, 2048, 132, page)
    assert plan is not None and plan.n_slices == 1
    assert 8 * hkv * plan.n_slices * n_split >= tda.SPLIT_WAVES * 132
    assert (n_split - 1) * rows < 2048 <= n_split * rows


# ---------------------------------------------------------------------------
# The pass model against the JAX package
# ---------------------------------------------------------------------------

def _quant(x):
    amax = np.abs(x).max(-1)
    s = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    return np.clip(np.round(x / s[..., None]), -127, 127).astype(np.int8), s


def _bf16(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


def _inputs(hq, hkv, D, L, quant, seed):
    """Rows: a long one, an idle slot (cur -1), a short one, one with cur
    set but nothing cached (no valid key) and stale entries past cur."""
    rng = np.random.default_rng(seed)
    B = 4
    q = _bf16(rng.standard_normal((B, hq, D)).astype(np.float32))
    k = rng.standard_normal((B, hkv, L, D)).astype(np.float32)
    v = rng.standard_normal((B, hkv, L, D)).astype(np.float32)
    ks = vs = None
    if quant:
        k, ks = _quant(k)
        v, vs = _quant(v)
    else:
        k, v = _bf16(k), _bf16(v)
    kpos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L)).copy()
    kpos[0, L - 40:] = -1
    kpos[3] = -1
    cur = np.asarray([L - 50, -1, 29, 100], np.int32)
    return dict(q=q, k=k, v=v, kpos=kpos, cur=cur, k_scale=ks, v_scale=vs)


def _model(t, split_rows, window=0):
    """The pass model on dense rows, merged as the merge kernel does."""
    T = {n: (None if a is None else torch.from_numpy(np.ascontiguousarray(a)))
         for n, a in t.items()}
    q = T["q"].bfloat16()
    k, v = T["k"], T["v"]
    if T["k_scale"] is None:
        k, v = k.bfloat16(), v.bfloat16()
    B, hq, D = q.shape
    g = hq // k.shape[1]
    plan = kreg.decode_group_plan(g, D)
    acc, m, l = tda.decode_group_partials_ref(
        q, k, v, T["kpos"], T["cur"], split_rows, plan, window=window,
        k_scale=T["k_scale"], v_scale=T["v_scale"])
    vf = v.float() * (1.0 if T["v_scale"] is None else T["v_scale"][..., None])
    out = tda.merge_partials_ref(acc, m, l,
                                 vf.mean(2).repeat_interleave(g, dim=1))
    mmax = m.amax(-1)
    fin = ~torch.isinf(mmax)
    lse = torch.where(fin, mmax + torch.log(
        (torch.exp(m - torch.where(fin, mmax, 0.0)[..., None]) * l).sum(-1)),
        float("-inf"))
    return out.numpy(), lse.numpy()


def _jax_lse(t, window=0):
    """ln sum exp of the scaled scores over the valid keys (-inf: none)."""
    k = t["k"].astype(np.float32)
    if t["k_scale"] is not None:
        k = k * t["k_scale"][..., None]
    g = t["q"].shape[1] // k.shape[1]
    s = jnp.einsum("bhd,bhld->bhl", jnp.asarray(t["q"]) * t["q"].shape[-1]
                   ** -0.5, jnp.repeat(jnp.asarray(k), g, axis=1))
    c = t["cur"][:, None]
    mask = (t["kpos"] >= 0) & (t["kpos"] <= c)
    if window:
        mask &= (c - t["kpos"]) < window
    return np.asarray(jax.nn.logsumexp(
        jnp.where(mask[:, None, :], s, -jnp.inf), axis=-1))


def _jax_dense(t, window, force):
    return np.asarray(jops.decode_attention(
        t["q"], t["k"], t["v"], t["kpos"], t["cur"], window=window,
        k_scale=t["k_scale"], v_scale=t["v_scale"], force=force)) \
        .astype(np.float32)


@pytest.mark.parametrize("hq,hkv,d", [(32, 2, 64), (48, 1, 32),
                                      (71, 1, 64), (16, 1, 264)])
@pytest.mark.parametrize("window,quant", [(0, False), (64, False),
                                          (0, True)])
def test_group_model_matches_jax_dense(hq, hkv, d, window, quant):
    """g 16, 48, 71 (and 16 at D 264, two key groups of 32-row tiles),
    split as the route cuts them, against repro.kernels.ref; the
    log-sum-exp too."""
    L = 256
    t = _inputs(hq, hkv, d, L, quant, seed=hq + d + window)
    rows = tda.launch_plan(4, hkv, hq // hkv, d, torch.bfloat16, L, 132)[1]
    got, lse = _model(t, rows, window)
    np.testing.assert_allclose(got, _jax_dense(t, window, "ref"), **TOL)
    ref_l = _jax_lse(t, window)
    assert np.array_equal(np.isinf(lse), np.isinf(ref_l))
    fin = ~np.isinf(ref_l)
    np.testing.assert_allclose(lse[fin], ref_l[fin], **LSE_TOL)
    assert np.isinf(ref_l[1]).all() and np.isinf(ref_l[3]).all()
    mean_v = (t["v"].astype(np.float32) * (
        1.0 if t["v_scale"] is None else t["v_scale"][..., None])).mean(2)
    for row in (1, 3):          # idle, and no valid key: the mean of V
        np.testing.assert_allclose(
            got[row], np.repeat(mean_v[row], hq // hkv, axis=0), **TOL)


@pytest.mark.parametrize("hq,hkv,quant", [(16, 1, False), (16, 1, True)])
def test_group_model_matches_pallas_interpret(hq, hkv, quant):
    """The same against the Pallas decode kernel in interpret mode (g 16,
    bf16 values and int8 rows), split rows where a split ends mid-tile."""
    t = _inputs(hq, hkv, 64, 128, quant, seed=7 + quant)
    got, _ = _model(t, 48)
    np.testing.assert_allclose(got, _jax_dense(t, 0, "interpret"), **TOL)


def _paged(t, ps, seed):
    """The dense rows scattered over a shuffled pool of ``ps``-row pages,
    page 0 the null page (kpos -1); row 3's table names only it, and row
    0's last entry repeats a page of its own."""
    B, hkv, L, D = t["k"].shape
    nb = L // ps
    rng = np.random.default_rng(seed)
    P = B * nb + 1
    bt = (rng.permutation(np.arange(1, P))[:B * nb].reshape(B, nb)
          .astype(np.int32))
    bt[3] = 0

    def scatter(x, fill):
        shp = (P, hkv, ps) + x.shape[3:] if x.ndim >= 3 else (P, ps)
        pool = np.full(shp, fill, dtype=x.dtype)
        for b in range(B):
            for j in range(nb):
                if bt[b, j]:
                    if x.ndim == 2:
                        pool[bt[b, j]] = x[b, j * ps:(j + 1) * ps]
                    else:
                        pool[bt[b, j]] = x[b, :, j * ps:(j + 1) * ps]
        return pool

    pool = dict(k=scatter(t["k"], 0), v=scatter(t["v"], 0),
                kpos=scatter(t["kpos"], -1),
                k_scale=None if t["k_scale"] is None
                else scatter(t["k_scale"], 1.0),
                v_scale=None if t["v_scale"] is None
                else scatter(t["v_scale"], 1.0))
    # the rows the kernel sweeps: the pages the table names, in order
    def gather(x):
        if x is None:
            return None
        g = x[bt]                       # (B, nb, [Hkv,] ps, ...)
        if x.ndim == 2:
            return g.reshape(B, nb * ps)
        return np.moveaxis(g, 2, 1).reshape((B, hkv, nb * ps) + x.shape[3:])

    rows = {n: gather(pool[n]) for n in ("k", "v", "kpos", "k_scale",
                                         "v_scale")}
    return pool, bt, dict(t, **rows)


@pytest.mark.parametrize("ps,hq,quant", [(4, 16, False), (8, 48, False),
                                         (16, 71, True), (12, 16, True)])
def test_group_model_matches_jax_paged(ps, hq, quant):
    """Pages of 4, 8 and 16 rows (the kernel's page shift) and of 12 (no
    shift: a division a row), null pages and a repeated page, split rows
    as the route cuts them (any row: splits need not end on a page)."""
    L = 192
    t = _inputs(hq, 1, 64, L, quant, seed=ps + hq)
    pool, bt, rows_t = _paged(t, ps, seed=ps)
    rows = tda.launch_plan(4, 1, hq, 64, torch.bfloat16, L, 132, ps)[1]
    got, _ = _model(rows_t, rows)
    ref = np.asarray(jops.paged_decode_attention(
        t["q"], pool["k"], pool["v"], pool["kpos"], bt, t["cur"],
        k_scale=pool["k_scale"], v_scale=pool["v_scale"], force="ref")) \
        .astype(np.float32)
    np.testing.assert_allclose(got, ref, **TOL)
    if ps == 8:
        ref_i = np.asarray(jops.paged_decode_attention(
            t["q"], pool["k"], pool["v"], pool["kpos"], bt, t["cur"],
            force="interpret")).astype(np.float32)
        np.testing.assert_allclose(got, ref_i, **TOL)


def test_group_model_key_groups_and_tiles_change_only_rounding():
    """The model's result does not hang on how it cuts a split (tiles,
    key groups): each cut agrees with the plain fp32 version within the
    bf16 tolerance, and two cuts differ by the rounding of P alone."""
    t = _inputs(16, 1, 64, 200, False, seed=3)
    T = {n: torch.from_numpy(np.ascontiguousarray(a)) for n, a in t.items()
         if a is not None}
    q, k, v = T["q"].bfloat16(), T["k"].bfloat16(), T["v"].bfloat16()
    ref = tda.decode_attention_ref(q.float(), k.float(), v.float(),
                                   T["kpos"], T["cur"])
    mean_v = v.float().mean(2).repeat_interleave(16, dim=1)
    outs = []
    for rows, kg in ((64, 1), (64, 4), (32, 2)):
        plan = kreg.GroupPlan(m=16, n_slices=1, rows=rows, stages=3,
                              key_groups=kg, col_groups=1, warps=kg)
        acc, m, l = tda.decode_group_partials_ref(q, k, v, T["kpos"],
                                                  T["cur"], 100, plan)
        outs.append(tda.merge_partials_ref(acc, m, l, mean_v))
        torch.testing.assert_close(outs[-1], ref, **TOL)
    torch.testing.assert_close(outs[0], outs[1], atol=2e-3, rtol=2e-3)
