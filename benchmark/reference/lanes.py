"""The interleaved entropy coder of ``sequential.py``, stepped over many
lanes at once.

A lane is one segment plane: its emissions (context, bit) in coding
order, coded with fresh context counters and an empty codeword buffer.
``sequential.encode_emissions`` codes one lane a bit at a time in Python;
here step ``t`` codes emission ``t`` of every lane with one NumPy call per
operation, so the cost is the longest lane's length, not the sum of the
lanes' lengths.  The rules are the same, word for word: counters with the
rescaling cap, bin selection on the inverted counts, a codeword opened per
bin, the oldest open codeword force-completed when the buffer of
``CIRC_BUF_SIZE`` words is full, the open words flushed at the end.

Each bin's codeword in progress is a state of a small automaton (Golomb
bins: the zeros counted so far; custom bins: the input prefix and its
length; the uncoded bin: none), so a step is table lookups.  Codewords
leave in allocation order, so a lane's payload is its words by index.
"""

from __future__ import annotations

import numpy as np

from . import constants as C
from .context_model import CTX_UNCODED

NBINS = C.ENCODER_BIN_MAX + 1
NCTX = C.CONTEXT_MAX + 2          # adaptive contexts 0..16 and CTX_UNCODED
S = int(C.GOLOMB_M.max())         # states per bin (Golomb's largest m)
BIG = np.int64(1) << 40           # "no open word"
CAP = C.CONTEXT_RESCALING_CAP


def _custom_state(prefix: int, nbits: int) -> int:
    return (1 << nbits) | prefix


def _tables():
    """(NEXT, DONE, OUTV, OUTB) over (bin, state, bit) and (FLV, FLB) over
    (bin, state): a step's next state and output, and a forced flush's."""
    nxt = np.zeros((NBINS, S, 2), np.int64)
    done = np.zeros((NBINS, S, 2), bool)
    outv = np.zeros((NBINS, S, 2), np.int64)
    outb = np.zeros((NBINS, S, 2), np.int64)
    flv = np.zeros((NBINS, S), np.int64)
    flb = np.zeros((NBINS, S), np.int64)
    for x in (0, 1):                       # uncoded bin: one bit a word
        done[0, 0, x] = True
        outv[0, 0, x] = x
        outb[0, 0, x] = 1
    for b in range(8, NBINS):              # Golomb run-length bins
        m = int(C.GOLOMB_M[b])
        for k in range(m):
            if k + 1 >= m:
                done[b, k, 0] = True
                outv[b, k, 0], outb[b, k, 0] = 1, 1
            else:
                nxt[b, k, 0] = k + 1
            done[b, k, 1] = True
            outv[b, k, 1] = int(C.GOLOMB_CODE_VALUE[b, k])
            outb[b, k, 1] = int(C.GOLOMB_CODE_BITS[b, k])
            if k == m - 1:
                flv[b, k], flb[b, k] = 1, 1
            else:
                flv[b, k] = int(C.GOLOMB_CODE_VALUE[b, k])
                flb[b, k] = int(C.GOLOMB_CODE_BITS[b, k])
    for b in range(1, 8):                  # custom variable-to-variable
        todo = [(0, 0)]
        while todo:
            prefix, nbits = todo.pop()
            s = 0 if nbits == 0 else _custom_state(prefix, nbits)
            if nbits:
                fv, fn = C.CUSTOM_FLUSH_BITS[b].get((prefix, nbits), (0, 0))
                p = prefix | (fv << nbits)
                flv[b, s] = int(C.CUSTOM_OUT_CODE[b, p])
                flb[b, s] = int(C.CUSTOM_OUT_BITS[b, p])
            for x in (0, 1):
                p = prefix | (x << nbits)
                n = nbits + 1
                if int(C.CUSTOM_IN_BITS[b, p]) == n:
                    done[b, s, x] = True
                    outv[b, s, x] = int(C.CUSTOM_OUT_CODE[b, p])
                    outb[b, s, x] = int(C.CUSTOM_OUT_BITS[b, p])
                else:
                    nxt[b, s, x] = _custom_state(p, n)
                    todo.append((p, n))
    return nxt, done, outv, outb, flv, flb


def _bin_table():
    """BIN[zero, total] for the (inverted) counts the coder meets."""
    z = np.arange(CAP + 1, dtype=np.int64)[:, None]
    t = np.arange(CAP + 1, dtype=np.int64)[None, :]
    comp = z * C.BIN_PROBABILITY_DENOMINATOR
    out = np.zeros((CAP + 1, CAP + 1), np.int64)
    for b in range(1, C.ENCODER_BIN_MAX + 1):
        cut = int(C.BIN_PROBABILITY_CUTOFFS[b - 1])
        out = np.where(comp >= t * cut, b, out)
    return out


NEXT, DONE, OUTV, OUTB, FLV, FLB = _tables()
BIN = _bin_table()
DONE_FLAT = DONE.reshape(-1)


def coded_bins(ctx: np.ndarray, bit: np.ndarray):
    """One lane's bins and inverted bits (int8), from the counters each
    emission meets (``sequential.ContextCounters``), all at once.

    A context's total count runs 4, 5, ..., 499, then 250..499 over and
    over (halved at 500), so only its zero count needs a recurrence: once
    per 250 of the context's bits."""
    n = len(ctx)
    ctx = ctx.astype(np.int8)
    bit = bit.astype(np.int8)
    o = np.argsort(ctx, kind="stable")               # by (ctx, position)
    co = ctx[o]
    pos = np.arange(n, dtype=np.int32)
    first = np.ones(n, bool)
    first[1:] = co[1:] != co[:-1]
    gstart = np.maximum.accumulate(np.where(first, pos, 0))
    k = pos - gstart                                 # rank in its context
    zc = np.zeros(n + 1, np.int32)
    np.cumsum(bit[o] == 0, out=zc[1:])
    first_rescale = CAP - C.DEFAULT_CONTEXT_TOTAL_COUNT
    half = CAP // 2
    late = k >= first_rescale
    ep = np.where(late, (k - first_rescale) // half + 1, 0)
    ks = np.where(late, first_rescale + (ep - 1) * half, 0)
    tot = np.where(late, half + k - ks, C.DEFAULT_CONTEXT_TOTAL_COUNT + k)
    # zero count at each epoch's start, context by context
    gfirst = np.nonzero(first)[0]
    glen = np.diff(np.append(gfirst, n))
    nep = np.where(glen <= first_rescale, 1,
                   (glen - first_rescale - 1) // half + 2)
    eoff = np.zeros(len(gfirst) + 1, np.int64)
    eoff[1:] = np.cumsum(nep)
    zstart = np.zeros(int(eoff[-1]), np.int32)
    zstart[eoff[:-1]] = C.DEFAULT_CONTEXT_ZERO_COUNT
    for e in range(1, int(nep.max())):
        g = np.nonzero(nep > e)[0]
        a = gfirst[g] + (0 if e == 1 else first_rescale + (e - 2) * half)
        bnd = gfirst[g] + first_rescale + (e - 1) * half
        z = zstart[eoff[g] + e - 1] + zc[bnd] - zc[a]
        zstart[eoff[g] + e] = np.where(z > half, z >> 1, z)
    gid = np.cumsum(first) - 1
    zero = zstart[eoff[gid] + ep] + zc[pos] - zc[gstart + ks]
    unc = co == CTX_UNCODED
    zero = np.where(unc, 1, zero)
    tot = np.where(unc, 2, tot)
    inv = zero < (tot >> 1)
    b = np.empty(n, np.int8)
    xb = np.empty(n, np.int8)
    b[o] = BIN[np.where(inv, tot - zero, zero), tot]
    xb[o] = bit[o] ^ inv
    return b, xb


def encode_lanes(ctx_list, bit_list, buffer_length: int = C.CIRC_BUF_SIZE):
    """Code each lane (``ctx_list[i]``, ``bit_list[i]``: the valid
    emissions in order).  Returns [(payload bytes, bit length)], as
    ``sequential.encode_emissions`` gives for each lane alone."""
    return code_bins([coded_bins(np.asarray(c), np.asarray(b))
                      for c, b in zip(ctx_list, bit_list)], buffer_length)


def code_bins(binned, buffer_length: int = C.CIRC_BUF_SIZE):
    """Code each lane from ``coded_bins``' (bins, inverted bits)."""
    n_lanes = len(binned)
    if n_lanes == 0:
        return []
    lens = np.array([len(b) for b, _ in binned], np.int64)
    order = np.argsort(-lens, kind="stable")      # longest first
    lens_o = lens[order]
    offs = np.zeros(n_lanes, np.int64)
    offs[1:] = np.cumsum(lens_o)[:-1]
    lane_of = np.repeat(np.arange(n_lanes, dtype=np.int64), lens_o)
    b = np.concatenate([binned[i][0] for i in order]).astype(np.int64)
    fidx = lane_of * NBINS + b                      # the bin's slot
    kbase = b * (2 * S)                             # (bin, state 0, bit)
    kbase += np.concatenate([binned[i][1] for i in order])
    del b
    total_len = len(fidx)

    state2 = np.zeros(n_lanes * NBINS, np.int64)     # open word's state x 2
    openw = np.full(n_lanes * NBINS, BIG, np.int64)  # open word's index
    count = np.zeros(n_lanes, np.int64)              # words allocated
    widx = np.zeros(total_len, np.int64)             # word of each emission
    tid = np.zeros(total_len, np.int64)              # (bin, state, bit)
    flushed = []                                     # (lane, word, v, nb)
    next2 = NEXT.reshape(-1) * 2
    # the lanes still coding at step t: the first active[t]
    active = np.searchsorted(-lens_o, -np.arange(int(lens_o[0])),
                             side="left").tolist()
    headroom = 0
    for t, n in enumerate(active):
        e = offs[:n] + t
        fi = fidx[e]
        s2 = state2[fi]
        alloc = s2 == 0
        if headroom <= 0:
            cn = count[:n]
            used = cn - np.minimum(openw[:n * NBINS].reshape(n, NBINS)
                                   .min(axis=1), cn)
            full = alloc & (used >= buffer_length)
            for lane in np.nonzero(full)[0].tolist():
                row = openw[lane * NBINS:(lane + 1) * NBINS]
                bo = int(row.argmin())
                f = lane * NBINS + bo
                so = int(state2[f]) // 2
                flushed.append((lane, int(openw[f]), int(FLV[bo, so]),
                                int(FLB[bo, so])))
                state2[f] = 0
                openw[f] = BIG
                used[lane] = cn[lane] - min(int(row.min()), int(cn[lane]))
            headroom = buffer_length - int(used.max()) - 1
        else:
            headroom -= 1
        w = np.where(alloc, count[:n], openw[fi])
        count[:n] += alloc
        k = kbase[e] + s2
        tid[e] = k
        widx[e] = w
        state2[fi] = next2[k]
        openw[fi] = np.where(DONE_FLAT[k], BIG, w)

    # end of plane: every open word flushed (sequential.flush)
    st = state2.reshape(n_lanes, NBINS) // 2
    ow = openw.reshape(n_lanes, NBINS)
    for lane, bo in zip(*(a.tolist() for a in np.nonzero(st != 0))):
        so = int(st[lane, bo])
        flushed.append((lane, int(ow[lane, bo]), int(FLV[bo, so]),
                        int(FLB[bo, so])))

    # words by index: the completing emission's output, or the flush's
    woff = np.zeros(n_lanes + 1, np.int64)
    woff[1:] = np.cumsum(count)
    val = np.zeros(int(woff[-1]), np.int64)
    nb = np.zeros(int(woff[-1]), np.int64)
    dm = DONE_FLAT[tid]
    g = woff[lane_of[dm]] + widx[dm]
    val[g] = OUTV.reshape(-1)[tid[dm]]
    nb[g] = OUTB.reshape(-1)[tid[dm]]
    for lane, wi, v, bits in flushed:
        val[woff[lane] + wi] = v
        nb[woff[lane] + wi] = bits

    out = [None] * n_lanes
    for j in range(n_lanes):
        v = val[woff[j]:woff[j + 1]]
        m = nb[woff[j]:woff[j + 1]]
        nbits = int(m.sum())
        rep = np.repeat(v, m)
        start = np.repeat(np.cumsum(m) - m, m)
        bits = (rep >> (np.arange(nbits) - start)) & 1
        out[int(order[j])] = (np.packbits(bits.astype(np.uint8),
                                          bitorder="little").tobytes(), nbits)
    return out
