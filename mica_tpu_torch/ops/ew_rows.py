"""Elementwise passes over (N, R, C) rows with an (R, C) table.

Counterpart of the five kernel bodies of ``scripts/distill_ew_crash.py``
(``build``, lines 56-162), which the TPU builders wrote to bisect a
compiler crash.  Each takes x viewed as (N, R, C) (N = D·H) and a table
(k, R, C) in f32, cast to x's dtype before use and broadcast over N; each
bf16 op rounds once, as the JAX bodies do.  Two Triton kernels, each
beside its plain PyTorch version:

  * K11 ``rows_ew``, bodies ``k1``-``k4`` (the TPU script's names):
      k1  y = relu((x - m)·s)
      k2  (y, z) = (relu(x̂), x̂), x̂ = (x - m)·s
      k3  y = (x - m)·s + t                         (table (3, R, C))
      k4  y = (g - m)·s, g = dy·[x > 0]
    ``out`` lets the TPU script's aliased variants write in place (into x
    for ``base`` and ``twoout_al``, into dy for ``twoin_al``);
    ``h_block`` picks the TPU script's ``*_hblk`` launch geometry, a grid
    over (channel block, D, H / h_block).
  * K12 ``masked_sq_stats`` (body ``k5``): (B, 2, C) f32 sums of g and g²
    over N and over the rows r with r mod B = b.  The TPU body groups row
    (h mod 8)·R + r of its block by that index mod B; with R a multiple of
    B, as in the script (R = 512, B = 8), that is r mod B.

Both are one streaming pass with a few flops per 2-byte element and a
table that stays in L2: bounded by device-memory bandwidth alone.  A
program loads its table tile once and walks rows of N with it (K11), or
sums its rows in registers and writes one partial (b_sz, 2, BLOCK_C) block
of a buffer, which a second kernel sums in a fixed order (K12, structured
like K5: no atomics, two calls give the same bits; ``k12_plan``).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from .conv3d_in import round_bf16_jit

launches = {"rows_ew": 0, "masked_sq_stats": 0}

BODIES = {"k1": 2, "k2": 2, "k3": 3, "k4": 2}   # body -> rows of its table
_MODE = {"k1": 1, "k2": 2, "k3": 3, "k4": 4}
_BF16 = torch.bfloat16
# launch shape, from a sweep on the H100 at the script's shapes: elements
# of a tile, warps of a program (the h-blocked grid, 8x fewer programs,
# takes twice as many), the programs K11's default grid and K12 aim at
TILE, WARPS, PROGRAMS_K11, PROGRAMS_K12 = 4096, 4, 4096, 1024
K12_SUM_ROWS, K12_SUM_C = 32, 32   # partials and channels a step of K12's sum kernel


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


def k12_plan(shape, b_sz: int = 8) -> dict:
    """K12's launch for x of ``shape`` (D, H, R, C): tiles of ``block_r``
    rows (a multiple of ``b_sz``) x ``block_c`` channels, ``n_r`` x ``n_c``
    of them, each program summing ``chunk`` of the N = D·H rows over one
    tile, ``n_chunks`` programs a tile; partial ``(chunk i, row block j)``
    is block ``i * n_r + j`` of the (1 + n_r·n_chunks, b_sz, 2, C) buffer,
    whose block 0 the sum kernel fills."""
    d, h, r, c = (int(v) for v in shape)
    block_c = min(128, _pow2_at_least(c))
    block_r = max(min(max(1, TILE // block_c), _pow2_at_least(r)), b_sz)
    n_r, n_c = -(-r // block_r), -(-c // block_c)
    n = d * h
    chunk = -(-n // max(1, min(n, PROGRAMS_K12 // (n_r * n_c))))
    n_chunks = -(-n // chunk)
    return dict(block_r=block_r, block_c=block_c, n_r=n_r, n_c=n_c, chunk=chunk,
                n_chunks=n_chunks, partials=n_r * n_chunks)


def rows_ew_plain(x: torch.Tensor, table: torch.Tensor, body: str,
                  dy: Optional[torch.Tensor] = None):
    """Plain version of K11, out of place: the body as an eager expression
    in x's dtype.  Returns y, or (y, z) for ``k2``."""
    t = table.to(x.dtype)
    m, s = t[0], t[1]
    if body == "k1":
        return torch.relu((x - m) * s)
    if body == "k2":
        xh = (x - m) * s
        return torch.relu(xh), xh
    if body == "k3":
        return (x - m) * s + t[2]
    if body == "k4":
        g = torch.where(x > 0, dy, torch.zeros((), dtype=dy.dtype))
        return (g - m) * s
    raise ValueError(f"unknown body {body!r}")


def masked_sq_stats_plain(x: torch.Tensor, dy: torch.Tensor, b_sz: int = 8) -> torch.Tensor:
    """Plain version of K12: (b_sz, 2, C) f32 sums of g = dy·[x > 0] and
    g² over the leading axes and over the rows r with r mod b_sz = b."""
    r, c = x.shape[-2:]
    g = torch.where(x > 0, dy, torch.zeros((), dtype=dy.dtype)).float().reshape(-1, r, c)
    groups = torch.arange(r, device=x.device) % b_sz
    out = torch.zeros((b_sz, 2, c), dtype=torch.float32, device=x.device)
    out[:, 0].index_add_(0, groups, g.sum(dim=0))
    out[:, 1].index_add_(0, groups, (g * g).sum(dim=0))
    return out


_kernels = None


def _triton():
    global _kernels
    if _kernels is None:
        import triton
        import triton.language as tl

        round_bf16 = round_bf16_jit()

        @triton.jit
        def rows_ew_kernel(x_ptr, dy_ptr, t_ptr, y_ptr, z_ptr, N, H, R, C, ROWS,
                           MODE: tl.constexpr, HBLK: tl.constexpr,
                           BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
            if HBLK:
                # the TPU script's (channel block, D, H / ROWS) grid: a
                # program takes ROWS rows of one d and every r block
                pid_c = tl.program_id(0)
                d = tl.program_id(1)
                h0 = tl.program_id(2) * ROWS
                n0 = d * H + h0
                n1 = d * H + tl.minimum(h0 + ROWS, H)
                rb0 = 0
                rb1 = tl.cdiv(R, BLOCK_R)
            else:
                # one table tile a program, ROWS rows of N through it
                pid_c = tl.program_id(1)
                n0 = tl.program_id(2) * ROWS
                n1 = tl.minimum(n0 + ROWS, N)
                rb0 = tl.program_id(0)
                rb1 = rb0 + 1
            cols = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
            cmask = cols < C
            RC = R * C
            for rb in range(rb0, rb1):
                rows = rb * BLOCK_R + tl.arange(0, BLOCK_R)
                mask = (rows < R)[:, None] & cmask[None, :]
                toff = rows[:, None] * C + cols[None, :]
                # the table is cast to bf16 first, as every body does
                m = round_bf16(tl.load(t_ptr + toff, mask=mask, other=0.0))
                s = round_bf16(tl.load(t_ptr + RC + toff, mask=mask, other=0.0))
                if MODE == 3:
                    t = round_bf16(tl.load(t_ptr + 2 * RC + toff, mask=mask, other=0.0))
                for n in range(n0, n1):
                    offs = n.to(tl.int64) * RC + toff
                    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
                    if MODE == 4:
                        dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
                        x = tl.where(x > 0, dy, 0.0)
                    # each op rounds to bf16, as the bf16 body does; integer
                    # rounding keeps the compiler from fusing a multiply-add
                    xh = round_bf16(round_bf16(x - m) * s)
                    if MODE == 3:
                        xh = xh + t
                    if MODE == 1 or MODE == 2:
                        # relu of the rounded value is exact in bf16
                        tl.store(y_ptr + offs, tl.maximum(xh, 0.0).to(tl.bfloat16), mask=mask)
                    else:
                        tl.store(y_ptr + offs, xh.to(tl.bfloat16), mask=mask)
                    if MODE == 2:
                        tl.store(z_ptr + offs, xh.to(tl.bfloat16), mask=mask)

        @triton.jit
        def masked_sq_stats_kernel(x_ptr, dy_ptr, buf_ptr, N, R, C, CHUNK, N_R,
                                   B_SZ: tl.constexpr, BLOCK_R: tl.constexpr,
                                   BLOCK_C: tl.constexpr):
            rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
            cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
            cmask = cols < C
            mask = (rows < R)[:, None] & cmask[None, :]
            toff = rows[:, None] * C + cols[None, :]
            acc_g = tl.zeros((BLOCK_R, BLOCK_C), dtype=tl.float32)
            acc_q = tl.zeros((BLOCK_R, BLOCK_C), dtype=tl.float32)
            n0 = tl.program_id(2) * CHUNK
            for n in range(n0, tl.minimum(n0 + CHUNK, N)):
                offs = n.to(tl.int64) * R * C + toff
                x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
                dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
                g = tl.where(x > 0, dy, 0.0)
                acc_g += g
                acc_q += g * g
            # a tile starts at a multiple of BLOCK_R, itself a multiple of
            # B_SZ: row i of the tile is in batch i mod B_SZ
            sg = tl.sum(tl.reshape(acc_g, (BLOCK_R // B_SZ, B_SZ, BLOCK_C)), axis=0)
            sq = tl.sum(tl.reshape(acc_q, (BLOCK_R // B_SZ, B_SZ, BLOCK_C)), axis=0)
            # this program's partial: block 1 + chunk * N_R + row block of
            # the (1 + partials, B_SZ, 2, C) buffer
            blk = 1 + tl.program_id(2) * N_R + tl.program_id(0)
            b = tl.arange(0, B_SZ)
            ptr = buf_ptr + (blk * B_SZ + b[:, None]) * 2 * C + cols[None, :]
            bmask = (b < B_SZ)[:, None] & cmask[None, :]
            tl.store(ptr, sg, mask=bmask)
            tl.store(ptr + C, sq, mask=bmask)

        @triton.jit
        def masked_sq_stats_sum_kernel(buf_ptr, C, P, BLOCK_P: tl.constexpr,
                                       BLOCK_C: tl.constexpr):
            # block 0 of the buffer, row (b, k) = the sum of the P partials'
            # rows (b, k) in a fixed order: BLOCK_P at a time, then across
            cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
            row = tl.program_id(1)                  # b * 2 + k
            R2 = tl.num_programs(1)
            cmask = cols < C
            acc = tl.zeros((BLOCK_P, BLOCK_C), dtype=tl.float32)
            for p0 in range(0, P, BLOCK_P):
                p = p0 + tl.arange(0, BLOCK_P)
                offs = ((1 + p) * R2 + row)[:, None] * C + cols[None, :]
                acc += tl.load(buf_ptr + offs, mask=(p < P)[:, None] & cmask[None, :], other=0.0)
            tl.store(buf_ptr + row * C + cols, tl.sum(acc, axis=0), mask=cmask)

        _kernels = (triton, rows_ew_kernel, (masked_sq_stats_kernel, masked_sq_stats_sum_kernel))
    return _kernels


def _tile(r: int, c: int, triton):
    """(BLOCK_R, BLOCK_C): up to 128 channels, ``TILE`` elements a tile,
    no more rows than R needs."""
    block_c = min(128, triton.next_power_of_2(c))
    return min(max(1, TILE // block_c), triton.next_power_of_2(r)), block_c


def _check_rows(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != _BF16 or not t.is_contiguous() or t.dim() != 4 or t.shape != ts[0].shape \
                or t.device != ts[0].device:
            raise TypeError(f"{name} on the card takes contiguous bf16 (D, H, R, C) tensors "
                            "of one shape on one device")


def rows_ew(x: torch.Tensor, table: torch.Tensor, body: str, dy: Optional[torch.Tensor] = None,
            out: Optional[torch.Tensor] = None, h_block: int = 0):
    """K11.  ``x`` (D, H, R, C); ``table`` (k, R, C) f32 with k as
    ``BODIES`` says; ``dy`` (D, H, R, C) for ``k4``.  y goes into ``out``
    when given (x or dy itself for the in-place variants), else into a new
    tensor; ``k2`` also returns z in a new tensor.  ``h_block`` > 0 takes
    the (channel block, D, H / h_block) grid.  Returns y, or (y, z)."""
    if body not in BODIES:
        raise ValueError(f"unknown body {body!r}; one of {sorted(BODIES)}")
    if (dy is None) != (body != "k4"):
        raise ValueError("dy is the input of k4 and of no other body")
    if x.device.type == "cpu":
        res = rows_ew_plain(x, table, body, dy)
        if out is None:
            return res
        y = res[0] if body == "k2" else res
        out.copy_(y)
        return (out, res[1]) if body == "k2" else out
    _check_rows("rows_ew", *(t for t in (x, dy, out) if t is not None))
    d, h, r, c = x.shape
    table = table.to(torch.float32).contiguous()
    if tuple(table.shape) != (BODIES[body], r, c) or table.device != x.device:
        raise ValueError(f"rows_ew {body}: the table must be ({BODIES[body]}, {r}, {c}) "
                         f"on {x.device}, got {tuple(table.shape)} on {table.device}")
    y = torch.empty_like(x) if out is None else out
    z = torch.empty_like(x) if body == "k2" else None
    triton, kernel, _ = _triton()
    block_r, block_c = _tile(r, c, triton)
    n_c = triton.cdiv(c, block_c)
    if h_block > 0:
        rows = h_block
        grid = (n_c, d, triton.cdiv(h, rows))
    else:
        # enough programs to fill the card, the table tile reused over
        # the rows of each
        n_r = triton.cdiv(r, block_r)
        rows = max(1, triton.cdiv(d * h * n_r * n_c, PROGRAMS_K11))
        grid = (n_r, n_c, triton.cdiv(d * h, rows))
    kernel[grid](x, x if dy is None else dy, table, y, y if z is None else z,
                 d * h, h, r, c, rows, MODE=_MODE[body], HBLK=h_block > 0,
                 BLOCK_R=block_r, BLOCK_C=block_c,
                 num_warps=2 * WARPS if h_block > 0 else WARPS)
    launches["rows_ew"] += 1
    return y if z is None else (y, z)


def masked_sq_stats(x: torch.Tensor, dy: torch.Tensor, b_sz: int = 8) -> torch.Tensor:
    """K12.  ``x``, ``dy`` (D, H, R, C) -> (b_sz, 2, C) f32 sums of g =
    dy·[x > 0] and g² over (D, H) and the rows r with r mod b_sz = b.
    ``b_sz`` is a power of two up to 64."""
    if x.device.type == "cpu":
        return masked_sq_stats_plain(x, dy, b_sz)
    if b_sz < 1 or b_sz > 64 or b_sz & (b_sz - 1):
        raise ValueError(f"masked_sq_stats: b_sz {b_sz} is not a power of two up to 64")
    _check_rows("masked_sq_stats", x, dy)
    d, h, r, c = x.shape
    triton, _, (kernel, _) = _triton()
    plan = k12_plan(x.shape, b_sz)
    # no atomics and no zero fill: each program writes its own partial block
    buf = torch.empty((1 + plan["partials"], b_sz, 2, c), dtype=torch.float32, device=x.device)
    kernel[(plan["n_r"], plan["n_c"], plan["n_chunks"])](
        x, dy, buf, d * h, r, c, plan["chunk"], plan["n_r"], B_SZ=b_sz,
        BLOCK_R=plan["block_r"], BLOCK_C=plan["block_c"], num_warps=WARPS)
    sum_partial_blocks(buf)
    launches["masked_sq_stats"] += 1
    return buf[0]


def sum_partial_blocks(buf: torch.Tensor) -> torch.Tensor:
    """K12's second pass alone: block 0 of the (1 + P, b_sz, 2, C) f32
    buffer on the card = the sum of blocks 1..P in a fixed order.
    ``masked_sq_stats`` launches it itself; this entry times it apart."""
    triton, _, (_, sum_kernel) = _triton()
    p1, b_sz, _, c = buf.shape
    sum_kernel[(triton.cdiv(c, K12_SUM_C), 2 * b_sz)](
        buf, c, p1 - 1, BLOCK_P=K12_SUM_ROWS, BLOCK_C=K12_SUM_C, num_warps=4)
    return buf[0]
