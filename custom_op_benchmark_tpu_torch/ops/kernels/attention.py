"""Fused block-sparse graph attention K4 and its diagnostic variant S5, each
beside its plain PyTorch version.

Counterparts of custom_op_benchmark_tpu/ops/pallas/attention.py (K4) and
``attn_variant`` in scripts/exp_grid_bisect.py (S5). Per row block I and
head h, over I's nonzero tiles (the src direction):

    s      = (Q[I] @ K[J(t)]ᵀ) · scale, non-edges set to -1e30
    m      = max(-1e9, max over I's tiles of s)        per row
    out[I] = Σ_t exp(s − m) @ V[J(t)] / Σ_t rowsum(exp(s − m)),
             or 0 for a row with no edges.

Both run the online-softmax recurrence in csrc/attention.cu, one tile at
a time, and never store a score in device memory, on one tensor-core
kernel: with Q resident for d ≤ 128, and for wider heads a thread block
cluster per row block whose blocks each own 64 or 128 features and sum
their shares of each tile's scores through distributed shared memory, so
the scores are computed once (:func:`kernel_route` states the layout). K4
takes float32 or bfloat16 (f32 accumulation, the input's dtype out); S5 is
the same kernel in float32 with the exponentials (``use_exp``) and the
mask (``use_mask``) switched off, at any head width (in bfloat16 only
with both on, where it is K4's bf16 launch). The plain K4
materialises the masked scores and composes the softmax in f32; the plain
S5 runs the recurrence one tile slot at a time over all row blocks, since
without ``exp`` it is not a softmax. Each wrapper runs its kernel on CUDA
tensors and its plain version only on CPU tensors;
``<wrapper>.launches`` counts kernel launches in float32,
``<wrapper>.launches_bf16`` those in bfloat16.
"""

from __future__ import annotations

import torch

from custom_op_benchmark_tpu_torch.ops.kernels._build import (
    call,
    check_cuda,
    on_cpu,
)
from custom_op_benchmark_tpu_torch.ops.kernels.tiled_kernels import (
    TILE,
    as_heads,
    check_mask,
    row_tiles,
    vec16,
)
from custom_op_benchmark_tpu_torch.ops.segments import sorted_segment_reduce

NEG_INF = -1e30
M_INIT = -1e9      # the kernel's first running max
RESIDENT_MAX_HEAD_DIM = 128  # widest head K4 runs with Q resident
MAX_CLUSTER = 8      # blocks a cluster holds at most (the portable size)


def fused_attention_rows_plain(tile_ptr, tile_cols, mask, q, k, v, scale):
    t, r, c = mask.shape
    nrb = tile_ptr.shape[0] - 1
    ptr = tile_ptr.long()
    rows = torch.repeat_interleave(torch.arange(nrb, device=q.device),
                                   ptr[1:] - ptr[:-1])
    qh, kh, vh = as_heads(q).float(), as_heads(k).float(), as_heads(v).float()
    qt = row_tiles(qh, rows, r)                            # (T, R, H, d)
    kt = row_tiles(kh, tile_cols, c)                       # (T, C, H, d)
    vt = row_tiles(vh, tile_cols, c)
    s = torch.einsum("trhd,tchd->htrc", qt, kt) * scale
    s = torch.where(mask, s, NEG_INF)
    m = sorted_segment_reduce(s.amax(-1), ptr, "max", dim=1)  # (H, NRB, R)
    m = m.clamp(min=M_INIT)
    p = torch.exp(s - m[:, rows, :, None])
    l = sorted_segment_reduce(p.sum(-1), ptr, "sum", dim=1)   # (H, NRB, R)
    acc = sorted_segment_reduce(
        torch.einsum("htrc,tchd->trhd", p, vt), ptr, "sum")   # (NRB, R, H, d)
    l = l.permute(1, 2, 0)[..., None]                         # (NRB, R, H, 1)
    out = torch.where(l > 0, acc / l.clamp(min=1e-30), 0.0)
    out = out.reshape((nrb * r,) + tuple(out.shape[2:]))[: q.shape[0]]
    out = out.to(q.dtype)
    return out[:, 0] if q.dim() == 2 else out


def check_kernel_args(tile_ptr, tile_cols, mask, q, k, v, *, s5=False):
    """The checks the CUDA kernel needs of its arguments; raises ValueError
    on anything it does not take. K4 takes float32 or bfloat16, S5
    (``s5=True``) float32; both any head width d ≥ 1. Returns
    (n_q, H, d, nrb)."""
    check_cuda(ints=(tile_ptr, tile_cols), floats=(q, k, v), bf16=not s5)
    check_mask(mask)
    n_q, h, d = (q.shape[0], 1, q.shape[1]) if q.dim() == 2 else q.shape
    nrb = tile_ptr.shape[0] - 1
    if d < 1:
        raise ValueError(f"head width {d} < 1")
    if n_q > nrb * TILE:
        raise ValueError(f"{n_q} query rows exceed {nrb} row blocks")
    if tile_cols.shape != mask.shape[:1]:
        raise ValueError(f"tile_cols {tuple(tile_cols.shape)} does not match "
                         f"{mask.shape[0]} mask tiles")
    return n_q, h, d, nrb


def kernel_route(d: int) -> tuple[str, int, int, int]:
    """The launch layout of the tensor-core kernel at head width d, as
    ``(form, blocks_per_cluster, clusters, width)`` per row block and head,
    ``width`` the features a block holds:

    - ``("mma", 1, 1, 64 or 128)`` for 1 ≤ d ≤ 128: one block, Q resident
      in shared memory;
    - ``("wide", C, Z, W)`` for d > 128: Z thread block clusters of C
      blocks, each block owning W features: W = 64 up to d = 512 (C =
      ceil(d / 64), a short chain of steps per block), else W = 128, C =
      min(8, ceil(d / 128)) and Z = ceil(d / 1024). Block b of cluster z
      writes output features [W·(C·z + b), +W) and contracts over the
      slices b, b + C, ... of d; the cluster sums the blocks' shares of
      each tile's scores, so each cluster computes them once.

    The C entry points take this layout as it is; no width takes the plain
    version."""
    if d < 1:
        raise ValueError(f"head width {d} < 1")
    if d <= RESIDENT_MAX_HEAD_DIM:
        return "mma", 1, 1, 64 if d <= 64 else 128
    width = 64 if d <= MAX_CLUSTER * 64 else 128
    slices = -(-d // width)
    blocks = min(MAX_CLUSTER, slices)
    return "wide", blocks, -(-slices // blocks), width


def _launch(fn, name, args, tile_ptr, tile_cols, mask, q, k, v, scale, s5):
    """One launch of ``name``'s entry point for q's dtype, counted on
    ``fn``, with the switches ``args`` after the launch layout."""
    n_q, h, d, nrb = check_kernel_args(tile_ptr, tile_cols, mask, q, k, v,
                                       s5=s5)
    if mask.data_ptr() % 16:
        raise ValueError("mask must be 16-byte aligned")
    # (n, d) and (n, 1, d) have the same layout: the kernel takes the
    # tensors as they are. Pointers go as ints (argtypes c_void_p): a
    # launch on the small graphs costs about as much host time as device
    # time, so the wrapper makes no views or ctypes objects.
    out = torch.empty_like(q)
    _, blocks, clusters, width = kernel_route(d)
    call(fn, name, q, tile_ptr.data_ptr(), tile_cols.data_ptr(),
         mask.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
         out.data_ptr(), nrb, h, d, n_q, k.shape[0], n_q, float(scale),
         vec16(d, q, k, v), blocks, clusters, width, *args)
    return out


def fused_attention_rows(tile_ptr, tile_cols, mask, q, k, v, scale: float):
    """q: (n_q, [H,] d), k/v: (n_kv, [H,] d), mask (T, R, C) →
    out (n_q, [H,] d), softmax over each row's tiles. n_q ≤ NRB·R; float32
    or bfloat16, any d ≥ 1."""
    if not q.shape[1:] == k.shape[1:] == v.shape[1:]:
        raise ValueError("q, k and v differ in heads or width")
    if on_cpu(tile_ptr, tile_cols, mask, q, k, v):
        return fused_attention_rows_plain(tile_ptr, tile_cols, mask, q, k, v,
                                          scale)
    return _launch(fused_attention_rows, "fused_attention_rows", (),
                   tile_ptr, tile_cols, mask, q, k, v, scale, s5=False)


fused_attention_rows.launches = fused_attention_rows.launches_bf16 = 0


# ---------------------------------------------------------------------------
# S5: K4 with the exponentials and the mask switched
# ---------------------------------------------------------------------------

def attn_variant_plain(tile_ptr, tile_cols, mask, q, k, v, scale,
                       use_exp=True, use_mask=True):
    """The recurrence of scripts/exp_grid_bisect.py ``_attn_body``, one tile
    slot at a time over all row blocks (slot s of a row block is its tile
    ptr[i] + s, if it has one)."""
    _, r, c = mask.shape
    nrb = tile_ptr.shape[0] - 1
    ptr = tile_ptr.long()
    counts = ptr[1:] - ptr[:-1]
    qh, kh, vh = as_heads(q), as_heads(k), as_heads(v)
    blocks = torch.arange(nrb, device=q.device)
    qt = row_tiles(qh, blocks, r)                            # (NRB, R, H, d)
    h = qh.shape[1]
    m = q.new_full((nrb, r, h), M_INIT)
    l = q.new_zeros((nrb, r, h))
    acc = torch.zeros_like(qt)
    n_slots = int(counts.max()) if nrb else 0
    for slot in range(n_slots):
        live = slot < counts                                  # (NRB,)
        t = (ptr[:-1] + slot).clamp(max=max(mask.shape[0] - 1, 0))
        kt = row_tiles(kh, tile_cols[t], c)                  # (NRB, C, H, d)
        vt = row_tiles(vh, tile_cols[t], c)
        s = torch.einsum("brhd,bchd->brch", qt, kt) * scale
        if use_mask:
            s = torch.where(mask[t][..., None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(2))
        if use_exp:
            p = torch.exp(s - m_new[:, :, None])
            corr = torch.exp(m - m_new)
        else:
            p = s - m_new[:, :, None]
            corr = m - m_new
        l_new = l * corr + p.sum(2)
        acc_new = acc * corr[..., None] + torch.einsum("brch,bchd->brhd",
                                                       p, vt)
        sel = live[:, None, None]
        m = torch.where(sel, m_new, m)
        l = torch.where(sel, l_new, l)
        acc = torch.where(sel[..., None], acc_new, acc)
    l = l[..., None]
    out = torch.where(l > 0, acc / l.clamp(min=1e-30), 0.0)
    out = out.reshape((nrb * r,) + tuple(out.shape[2:]))[: q.shape[0]]
    return out[:, 0] if q.dim() == 2 else out


def attn_variant(tile_ptr, tile_cols, mask, q, k, v, scale: float, *,
                 use_exp: bool = True, use_mask: bool = True):
    """S5: :func:`fused_attention_rows` with ``use_exp=False`` (p = s − m,
    corr = m_prev − m) and/or ``use_mask=False`` (every column of each tile
    counts, key rows past n reading as zero). A diagnostic: K4's kernel
    with its switches, float32, any d ≥ 1; with both on it is K4's
    launch, bit for bit. In bfloat16 it takes only both switches on, where
    it is K4's bf16 launch (and K4's plain version on the CPU)."""
    if not q.shape[1:] == k.shape[1:] == v.shape[1:]:
        raise ValueError("q, k and v differ in heads or width")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and not (use_exp and use_mask):
        raise ValueError("attn_variant takes bfloat16 only with use_exp and "
                         "use_mask on (K4's bf16 kernel); got use_exp="
                         f"{use_exp}, use_mask={use_mask}")
    if on_cpu(tile_ptr, tile_cols, mask, q, k, v):
        if bf16:
            return fused_attention_rows_plain(tile_ptr, tile_cols, mask, q, k,
                                              v, scale)
        return attn_variant_plain(tile_ptr, tile_cols, mask, q, k, v, scale,
                                  use_exp, use_mask)
    if bf16:     # K4's bf16 launch, counted on attn_variant
        return _launch(attn_variant, "fused_attention_rows", (), tile_ptr,
                       tile_cols, mask, q, k, v, scale, s5=False)
    return _launch(attn_variant, "attn_variant", (int(use_exp),
                                                  int(use_mask)),
                   tile_ptr, tile_cols, mask, q, k, v, scale, s5=True)


attn_variant.launches = attn_variant.launches_bf16 = 0


def well_posed_s5(tg, d: int, *, device=None, seed: int = 0):
    """Inputs on which S5 without ``exp`` is well posed, for ``tg``'s tiling
    at width d: ``(mask, q, k, v, scale)``.

    Without ``exp`` the recurrence is ``l = l·(m_prev − m) + Σ(s − m)``, a
    sum whose terms change sign, and a masked score (−1e30) multiplied by a
    jump of the running max overflows, so on general inputs rounding
    decides the sign of ``l`` and whether a row reads 0. Here:

    - every live row is a whole tile row (the even rows of each tile); the
      odd rows are masked out everywhere (their m stays −1e9, so
      m_prev − m = 0 and they read 0). Where n is not a multiple of 128,
      the keys past n (zero) score 0 in a row's last tile and their −m
      terms make ``l`` negative, so those rows read 0 in every version;
    - q is 1 in features 0 and 1; k holds 16 × the key's column block in
      feature 0 and ±1 in feature 1; v holds two entries of ±1; scale 1/8.
      So every score is exact in f32 (and in 3xTF32), a tile's scores
      spread by 1/4, and the row maxima rise by at least 2 from one of a
      row's tiles to the next: |l·(m_prev − m)| outgrows |Σ(s − m)| and no
      rounding can flip the sign of l.
    """
    n = tg.n_nodes
    gen = torch.Generator(device=device).manual_seed(seed)

    def pm1(shape):
        return torch.randint(0, 2, shape, device=device,
                             generator=gen).float() * 2 - 1

    q = torch.zeros(n, d, device=device)
    q[:, :2] = 1.0
    k = torch.zeros(n, d, device=device)
    k[:, 0] = (torch.arange(n, device=device) // TILE).float() * 16
    k[:, 1] = pm1((n,))
    v = torch.zeros(n, d, device=device)
    v[:, :2] = pm1((n, 2))
    live = torch.arange(TILE, device=device) % 2 == 0
    mask = live[None, :, None].expand(tg.num_tiles, TILE, TILE).contiguous()
    return mask, q, k, v, 0.125
