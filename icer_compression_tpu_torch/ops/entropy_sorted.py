"""Sort-centric entropy coder: the ``sorted`` coder backend.

Counterpart: ``icer_compression_tpu/ops/entropy_jax2.py``
(``encode_emissions_sorted``: ``counters_and_bins_sorted``,
``build_records`` with ``_prefix_compose5``, ``_select_over_bins`` and
``_custom_lookup``, ``detect_flush_records``, and ``pack_records_tree``
through ``ops/pack``), with the custom-code window and tail tables of
``icer_compression_tpu/ops/entropy_vec.py`` (``_build_custom_luts``).

The JAX functions take one lane; here every function takes a batch of
lanes as the rows of (lanes, L) tensors and works along the last axis.
Stable sorts stand for ``_sort_by``, ``torch.cummax`` for ``_cummax``,
``index_add_`` for ``_small_scatter_add`` and table gathers for the
packed-constant lookups.  It is plain PyTorch with no kernel of its own,
as XLA ran it on the TPU.  A lane that needs the reorder-window flush, or
whose payload passes ``max_bits``, sets its flag (the caller re-encodes it
on the host).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import constants as C
from .pack import bitrev16, pack_records

BIG = 2 ** 30
NCTX_SENT = 18          # sort key for invalid emissions (contexts 0..17)
NBIN_SENT = 17          # bin of invalid emissions (bins 0..16)
_CHUNK = C.CONTEXT_RESCALING_CAP // 2                       # 250
_FIRST = C.CONTEXT_RESCALING_CAP - C.DEFAULT_CONTEXT_TOTAL_COUNT  # 496


def _build_custom_luts():
    """Per bin: window LUT over 5-bit (LSB-first) patterns -> (len, code,
    nbits); tail LUT over (prefix bits, prefix value) -> (code, nbits),
    with the reference's flush bits appended (icer_encoding.c:168-181).
    Row NBIN_SENT is zero, like every non-custom bin."""
    n = NBIN_SENT + 1
    win_len = np.zeros((n, 32), np.int64)
    win_code = np.zeros((n, 32), np.int64)
    win_bits = np.zeros((n, 32), np.int64)
    tail_code = np.zeros((n, 5, 16), np.int64)
    tail_bits = np.zeros((n, 5, 16), np.int64)
    for b in C.CUSTOM_CODES:
        for w in range(32):
            v = 0
            for j in range(5):
                v |= ((w >> j) & 1) << j
                if int(C.CUSTOM_IN_BITS[b, v & 31]) == j + 1:
                    win_len[b, w] = j + 1
                    win_code[b, w] = int(C.CUSTOM_OUT_CODE[b, v & 31])
                    win_bits[b, w] = int(C.CUSTOM_OUT_BITS[b, v & 31])
                    break
        for nb in range(1, 5):
            for v in range(1 << nb):
                fv, _fn = C.CUSTOM_FLUSH_BITS[b].get((v, nb), (0, 0))
                fin = v | (fv << nb)
                tail_code[b, nb, v] = int(C.CUSTOM_OUT_CODE[b, fin & 31])
                tail_bits[b, nb, v] = int(C.CUSTOM_OUT_BITS[b, fin & 31])
    return (win_len, win_code, win_bits, tail_code.reshape(n, 80),
            tail_bits.reshape(n, 80))


(WIN_LEN, WIN_CODE, WIN_BITS, TAIL_CODE, TAIL_BITS) = _build_custom_luts()


def _golomb_tables():
    """Golomb (m, l, i) per bin 0..NBIN_SENT; (1, 1, 0) outside 8..16."""
    m = np.ones(NBIN_SENT + 1, np.int64)
    l_ = np.ones(NBIN_SENT + 1, np.int64)
    i = np.zeros(NBIN_SENT + 1, np.int64)
    m[8:17], l_[8:17], i[8:17] = C.GOLOMB_M[8:17], C.GOLOMB_L[8:17], \
        C.GOLOMB_I[8:17]
    return m, l_, i


@functools.lru_cache(maxsize=None)
def _tables(device: str):
    gm, gl, gi = _golomb_tables()
    cut = C.BIN_PROBABILITY_CUTOFFS[:16].astype(np.int64)
    return {k: torch.as_tensor(v, device=device) for k, v in dict(
        gm=gm, gl=gl, gi=gi, cut=cut, win_len=WIN_LEN, win_code=WIN_CODE,
        win_bits=WIN_BITS, tail_code=TAIL_CODE, tail_bits=TAIL_BITS).items()}


@functools.lru_cache(maxsize=None)
def _chunk_starts(J: int, device: str) -> torch.Tensor:
    """The occurrence at which each of J rescale chunks starts, (1, J, 1)
    on ``device``: uploaded once, since a captured pass may not copy from
    the host."""
    b_vals = np.concatenate([[0], _FIRST + _CHUNK * np.arange(J - 1)])
    return torch.as_tensor(b_vals, device=device)[None, :, None]


def _lookup(table: torch.Tensor, b: torch.Tensor, idx: torch.Tensor):
    """table[b, idx] elementwise (the per-bin packed-constant lookup)."""
    return table.reshape(-1)[b * table.shape[1] + idx]


def _cummax(a: torch.Tensor) -> torch.Tensor:
    return torch.cummax(a, dim=-1).values


def _shift1(a: torch.Tensor, fill) -> torch.Tensor:
    """out[i] = a[i - 1], out[0] = fill."""
    return torch.nn.functional.pad(a[..., :-1], (1, 0), value=fill)


def _shiftl(a: torch.Tensor, k: int, fill) -> torch.Tensor:
    """out[i] = a[i + k], tail filled."""
    if k == 0:
        return a
    return torch.nn.functional.pad(a[..., k:], (0, k), value=fill)


def _sort_by(key: torch.Tensor, *ops: torch.Tensor):
    """Stable ascending sort of each row by ``key``; returns (sorted key,
    sorted ops)."""
    skey, order = torch.sort(key, dim=-1, stable=True)
    return skey, [torch.gather(o, -1, order) for o in ops]


def _small_scatter_add(n: int, idx: torch.Tensor, vals: torch.Tensor):
    """Per row, scatter-add a small number of updates into length n."""
    rows = idx.shape[0]
    out = torch.zeros(rows * n, dtype=torch.int64, device=idx.device)
    flat = (torch.arange(rows, device=idx.device)[:, None] * n
            + torch.clamp(idx, 0, n - 1)).reshape(-1)
    out.index_add_(0, flat, vals.reshape(-1))
    return out.reshape(rows, n)


def _shift_rows(a: torch.Tensor) -> torch.Tensor:
    """a shifted down by one along axis 1 (row j reads row j - 1)."""
    return torch.cat([torch.zeros_like(a[:, :1]), a[:, :-1]], dim=1)


# ---- stage 1: counters and bins (context-sorted space) -------------------

def counters_and_bins_sorted(valid, ctx, bit, max_chunks=None):
    """(lanes, L) emission streams -> (spos, sbin, scoded): emission
    position, bin and coded bit in context-sorted order (invalid
    emissions carry bin NBIN_SENT)."""
    lanes, L = valid.shape
    dev = valid.device
    T = _tables(str(dev))
    J = max_chunks or ((L - _FIRST) // _CHUNK + 2 if L > _FIRST else 2)
    pos = torch.arange(L, device=dev)
    ctx_eff = torch.where(valid != 0, ctx.to(torch.int64), NCTX_SENT)
    skey, (sbit,) = _sort_by(ctx_eff * L + pos, bit.to(torch.int64))
    sctx = skey // L
    spos = skey % L

    idx = pos
    zb = ((sbit == 0) & (sctx <= 16)).to(torch.int64)
    grp_start = torch.nn.functional.pad(sctx[:, 1:] != sctx[:, :-1], (1, 0),
                                        value=True)
    occ = idx - _cummax(torch.where(grp_start, idx, 0))
    cz = torch.cumsum(zb, dim=-1)
    cz_excl = cz - zb
    seg_cz_excl = cz_excl - _cummax(torch.where(grp_start, cz_excl, -1))
    total = torch.where(occ < _FIRST, C.DEFAULT_CONTEXT_TOTAL_COUNT + occ,
                        _CHUNK + (occ - _FIRST) % _CHUNK)

    # ---- rescale-chunk state
    cvals = torch.arange(NCTX_SENT + 1, device=dev).expand(lanes, -1)
    gs = torch.searchsorted(sctx.contiguous(), cvals.contiguous())
    n_c = (gs[:, 1:] - gs[:, :-1])[:, :17]       # adaptive contexts only
    gs17 = gs[:, :17]
    Bj = _chunk_starts(J, str(dev))              # (1, J, 1)
    exists = Bj < n_c[:, None, :]                # chunk j exists in ctx c
    # zeros among the first min(Bj, n_c) occurrences of each context
    cz_pad = torch.cat([cz_excl, cz[:, -1:]], dim=-1)
    kpos = torch.clamp(gs17[:, None, :] + torch.minimum(Bj, n_c[:, None, :]),
                       0, L)
    base = torch.gather(cz_pad, 1, torch.clamp(gs17, 0, L))[:, None, :]
    czK = torch.gather(cz_pad, 1, kpos.reshape(lanes, -1)).reshape(
        lanes, J, 17) - base

    # chunk scan: z at the start of each chunk
    czK_ext = torch.cat([czK, czK[:, -1:]], dim=1)
    z = torch.full((lanes, 17), C.DEFAULT_CONTEXT_ZERO_COUNT,
                   dtype=torch.int64, device=dev)
    zs = [z]
    for j in range(J - 1):
        zj = z + (czK_ext[:, j + 1] - czK_ext[:, j])
        z = torch.where(zj > _CHUNK, zj >> 1, zj)
        zs.append(z)
    z_starts = torch.stack(zs, dim=1)            # (lanes, J, 17)

    # ---- piecewise-constant expansion (delta scatter + cumsum)
    zlast_idx = torch.clamp(torch.where(
        n_c > 0, torch.where(n_c - 1 < _FIRST, 0,
                             1 + torch.clamp(n_c - 1 - _FIRST, min=0)
                             // _CHUNK), 0), 0, J - 1)
    zlast = torch.gather(z_starts, 1, zlast_idx[:, None, :])[:, 0]
    czlast = torch.gather(czK, 1, zlast_idx[:, None, :])[:, 0]
    czlast = torch.where(n_c > 0, czlast, 0)
    zlast = torch.where(n_c > 0, zlast, 0)
    # running value before each group = the last value of the previous
    # non-empty group (17-step chain)
    run_z = torch.zeros(lanes, dtype=torch.int64, device=dev)
    run_cz = torch.zeros_like(run_z)
    prev_z, prev_cz = [], []
    for c in range(17):
        prev_z.append(run_z)
        prev_cz.append(run_cz)
        run_z = torch.where(n_c[:, c] > 0, zlast[:, c], run_z)
        run_cz = torch.where(n_c[:, c] > 0, czlast[:, c], run_cz)
    prev_z = torch.stack(prev_z, dim=1)
    prev_cz = torch.stack(prev_cz, dim=1)
    dz = torch.where(Bj == 0, z_starts - prev_z[:, None, :],
                     z_starts - _shift_rows(z_starts))
    dcz = torch.where(Bj == 0, czK - prev_cz[:, None, :],
                      czK - _shift_rows(czK))
    bnd_pos = torch.where(exists, gs17[:, None, :] + Bj, L + 1)
    zdelta = _small_scatter_add(L + 2, bnd_pos.reshape(lanes, -1),
                                torch.where(exists, dz, 0))
    czdelta = _small_scatter_add(L + 2, bnd_pos.reshape(lanes, -1),
                                 torch.where(exists, dcz, 0))
    zero = (torch.cumsum(zdelta[:, :L], dim=-1)
            + (seg_cz_excl - torch.cumsum(czdelta[:, :L], dim=-1)))

    # uncoded / invalid overrides
    unc = sctx == 17
    zero = torch.where(unc, 1, zero)
    total = torch.where(unc, 2, total)
    inv = zero < (total >> 1)
    zero = torch.where(inv, total - zero, zero)
    scoded = sbit ^ inv.to(torch.int64)
    comp = zero * C.BIN_PROBABILITY_DENOMINATOR
    sbin = torch.zeros_like(comp)
    for q in range(16):
        sbin += (comp >= total * T["cut"][q]).to(torch.int64)
    sbin = torch.where(sctx >= NCTX_SENT, NBIN_SENT, sbin)
    return spos, sbin, scoded


# ---- stage 2+3: codewords (bin-sorted space) -> records (open order) -----

def _prefix_compose5(trans: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix composition along the last axis of (5, ..., L)
    countdown transitions: out[d][i] = the state after element i when
    the state before element 0 is d."""
    L = trans.shape[-1]
    pref = trans
    step = 1
    while step < L:
        later = pref[..., step:]
        earlier = pref[..., :L - step]
        composed = torch.gather(later, 0, earlier)
        pref = torch.cat([pref[..., :step], composed], dim=-1)
        step *= 2
    return pref


def build_records(spos, sbin, scoded):
    """Codeword records in allocation (opening) order, per lane.

    Returns (open_o, code_o, nbits_o, done_o, valid_o), each (lanes, L):
    record i is the i-th codeword allocated; valid_o marks real records;
    done_o is BIG for words completed only by the end-of-plane flush."""
    lanes, L = spos.shape
    dev = spos.device
    T = _tables(str(dev))
    skey, (cb,) = _sort_by(sbin * L + spos, scoded)
    b = skey // L
    p = skey % L

    idx = torch.arange(L, device=dev)
    seg_start = torch.nn.functional.pad(b[:, 1:] != b[:, :-1], (1, 0),
                                        value=True)
    seg_start_idx = _cummax(torch.where(seg_start, idx, 0))
    seg_last = torch.nn.functional.pad(b[:, :-1] != b[:, 1:], (0, 1),
                                       value=True)
    is0 = b == 0
    isC = (b >= 1) & (b <= 7)
    isG = (b >= 8) & (b <= 16)

    # ---- golomb
    m_e, l_e, i_e = T["gm"][b], T["gl"][b], T["gi"][b]
    one = isG & (cb == 1)
    prev_one_excl = _shift1(_cummax(torch.where(one, idx, -1)), -1)
    reset_base = torch.maximum(prev_one_excl, seg_start_idx - 1)
    run_pos = idx - reset_base - 1
    ends_g_real = one | (isG & (cb == 0) & (run_pos % m_e == m_e - 1))

    # ---- custom: 5-bit forward windows within the segment
    w = torch.zeros_like(b)
    for j in range(5):
        same = _shiftl(b, j, -1) == b
        w = w | (torch.where(same, _shiftl(cb, j, 0), 0) << j)
    clen = _lookup(T["win_len"], b, w)
    cl1 = torch.clamp(clen - 1, 0, 4)
    # countdown automaton with per-segment resets: d == 0 starts a word
    # (next state clen - 1), else counts down; a segment start starts a
    # word from any state; outside custom bins the identity
    rows = []
    for d in range(5):
        base = cl1 if d == 0 else torch.full_like(cl1, d - 1)
        rows.append(torch.where(isC, torch.where(seg_start, cl1, base), d))
    state_after = _prefix_compose5(torch.stack(rows))[0]
    ends_c_real = isC & (state_after == 0)

    # ---- ends (incl. per-segment virtual flush ends)
    ends_real = ends_g_real | ends_c_real | is0
    virt = seg_last & (isG | isC) & ~ends_real
    ends = ends_real | virt
    prev_end_excl = torch.maximum(
        _shift1(_cummax(torch.where(ends, idx, -1)), -1), seg_start_idx - 1)
    span = idx - prev_end_excl                   # word length at an end

    # golomb codeword attrs at ends
    kz = (span - 1) + (cb == 0).to(torch.int64)  # zeros consumed
    kz = torch.minimum(torch.clamp(kz, min=0), m_e)
    adj = torch.where(kz < i_e, kz, kz + i_e)
    gn = l_e + (kz >= i_e).to(torch.int64)
    gcode = bitrev16(adj, gn)
    one_bit = (kz >= m_e) | (virt & (kz == m_e - 1))   # full run, flush quirk
    gcode = torch.where(one_bit, 1, gcode)
    gn = torch.where(one_bit, 1, gn)

    # custom codeword attrs at ends
    vlen = torch.clamp(span, 1, 5)
    v = torch.zeros_like(b)
    sh = cb
    for j in range(5):
        if j > 0:
            sh = _shift1(sh, 0)
        v = v | torch.where(j < vlen, sh << torch.clamp(vlen - 1 - j, 0, 4),
                            0)
    vc = torch.clamp(v, 0, 31)
    tidx = torch.clamp(vlen, 0, 4) * 16 + torch.clamp(v, 0, 15)
    ccode = torch.where(virt, _lookup(T["tail_code"], b, tidx),
                        _lookup(T["win_code"], b, vc))
    cn = torch.where(virt, _lookup(T["tail_bits"], b, tidx),
                     _lookup(T["win_bits"], b, vc))

    code_e = torch.where(isG, gcode, torch.where(isC, ccode, cb))
    nbits_e = torch.where(isG, gn, torch.where(isC, cn, 1))
    done_e = torch.where(virt, BIG, p)

    # ---- starts, then records in allocation order
    starts = (isG | isC | is0) & (seg_start | _shift1(ends, True))
    skey_s, (open_pos,) = _sort_by(torch.where(starts, idx, BIG), p)
    s_ok = skey_s != BIG
    packed_e = (code_e & 0xFFFF) | (nbits_e << 16)
    ekey_s, (packed_r, done_r) = _sort_by(torch.where(ends, idx, BIG),
                                          packed_e, done_e)
    rec_valid = s_ok & (ekey_s != BIG)
    rkey_s, (packed_o, done_o) = _sort_by(
        torch.where(rec_valid, open_pos, BIG), packed_r, done_r)
    valid_o = rkey_s != BIG
    open_o = torch.where(valid_o, rkey_s, BIG)
    return (open_o, packed_o & 0xFFFF, (packed_o >> 16) & 31, done_o,
            valid_o)


def detect_flush_records(open_o: torch.Tensor, done_o: torch.Tensor,
                         rec_valid: torch.Tensor) -> torch.Tensor:
    """Mid-plane reorder-window flush condition, in record space: record
    k must have popped record k - CIRC_BUF_SIZE before allocating, which
    in allocation order is a shift of the running maximum of completion
    times (icer_encoding.c:200-206).  Rows of (lanes, R) tensors; returns
    one flag per lane."""
    n = open_o.shape[-1]
    if n <= C.CIRC_BUF_SIZE:
        return torch.zeros(open_o.shape[:-1], dtype=torch.bool,
                           device=open_o.device)
    runmax = _cummax(torch.where(rec_valid, done_o, -1))
    old = torch.nn.functional.pad(runmax[..., :-C.CIRC_BUF_SIZE],
                                  (C.CIRC_BUF_SIZE, 0), value=-1)
    return (rec_valid & (old >= open_o)).any(dim=-1)


def encode_emissions_sorted(valid, ctx, bit, max_bits: int | None = None):
    """Full sort-centric encode of (lanes, L) emission streams -> per lane
    (payload uint8 (lanes, max_bits // 8), total bits int64, flag bool).
    ``max_bits`` (a multiple of 32; default 10 bits per emission) caps the
    payload; the flag marks lanes that need the reorder-window flush or
    pass the cap."""
    L = valid.shape[-1]
    if max_bits is None:
        max_bits = -(-10 * L // 32) * 32
    spos, sbin, scoded = counters_and_bins_sorted(valid, ctx, bit)
    open_o, code_o, nbits_o, done_o, rec_valid = build_records(
        spos, sbin, scoded)
    flush = detect_flush_records(open_o, done_o, rec_valid)
    payload, total, over = pack_records(code_o, nbits_o, rec_valid, max_bits)
    return payload, total, flush | over
