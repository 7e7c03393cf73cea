"""RLE1 — bzip2's initial run-length encoding, with lbzip2-exact block
splitting.

Spec source: reference src/encode.c:136-336 (collect) and :443-447
(finalization in encode()).  Semantics reproduced:

- maximal input runs are chunked at 259 (MAX_RUN_LENGTH); a chunk of
  length r < 4 emits r literals; r >= 4 emits 4 literals + a length byte
  (r - 4).  Both the run character and the length byte enter the block's
  character map.
- blocks are filled greedily to max_block_size output bytes, with two
  quirks that must be reproduced for bit-exact parity:
  (a) the "state-3 reservation": when exactly one output slot remains
      after writing the 3rd character of a run whose next input char
      continues the run, the block is closed with that slot EMPTY
      (blocks of max_block_size - 1 bytes exist);
  (b) when a block closes mid-run, the remaining input re-enters RLE1
      from scratch in the next block (runs do not straddle blocks).
- the block CRC is the CRC of the *consumed input span* (not the RLE
  output).

Implementation is vectorized over maximal runs; only the single block
boundary run is handled scalarly per block.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lbzip2_tpu_torch.core.constants import MAX_RUN_LENGTH

_CHUNK = MAX_RUN_LENGTH  # 259


def find_runs(data: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Maximal runs of `data` → (starts, lengths, chars)."""
    n = data.size
    if n == 0:
        e = np.zeros(0, dtype=np.int64)
        return e, e, np.zeros(0, dtype=np.uint8)
    boundary = np.empty(n, dtype=bool)
    boundary[0] = True
    np.not_equal(data[1:], data[:-1], out=boundary[1:])
    starts = np.flatnonzero(boundary)
    lengths = np.diff(np.append(starts, n))
    return starts.astype(np.int64), lengths.astype(np.int64), data[starts]


def _out_len_of_run(length: int) -> int:
    """RLE output bytes for one maximal run (no capacity limit)."""
    full, rem = divmod(length, _CHUNK)
    out = full * 5
    out += rem if rem < 4 else 5
    return out


def run_out_lengths(lengths: np.ndarray) -> np.ndarray:
    full, rem = np.divmod(lengths, _CHUNK)
    return full * 5 + np.where(rem < 4, rem, 5)


@dataclass
class BlockSpan:
    """One bzip2 block's input span and RLE1 result."""

    start: int  # input offset of first consumed byte
    end: int  # input offset past last consumed byte
    data: np.ndarray  # RLE1-transformed block bytes (uint8)
    cmap: np.ndarray  # bool[256] character usage map


def transform_span(data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """RLE1-transform a complete input span (runs start fresh at offset 0).

    Returns (out_bytes, cmap).  The caller guarantees the span was chosen
    so the output respects the block size limit.
    """
    starts, lengths, chars = find_runs(data)
    if starts.size == 0:
        return np.zeros(0, dtype=np.uint8), np.zeros(256, dtype=bool)

    # Expand runs into <=259 pieces.
    full, rem = np.divmod(lengths, _CHUNK)
    counts = full + (rem > 0)
    run_of_piece = np.repeat(np.arange(starts.size), counts)
    ends = np.cumsum(counts)
    idx_in_run = np.arange(run_of_piece.size) - np.repeat(ends - counts, counts)
    piece_len = np.where(idx_in_run < full[run_of_piece], _CHUNK,
                         rem[run_of_piece])
    piece_char = chars[run_of_piece]

    long = piece_len >= 4
    lit_counts = np.where(long, 4, piece_len)
    out_per_piece = lit_counts + long
    out_ends = np.cumsum(out_per_piece)
    total = int(out_ends[-1])

    out = np.empty(total, dtype=np.uint8)
    # Literals: positions [out_end - out_per, out_end - long)
    lit_idx = (np.arange(int(lit_counts.sum()))
               - np.repeat(np.cumsum(lit_counts) - lit_counts, lit_counts)
               + np.repeat(out_ends - out_per_piece, lit_counts))
    out[lit_idx] = np.repeat(piece_char, lit_counts)
    # Length bytes at out_end-1 for long pieces.
    lb_vals = (piece_len[long] - 4).astype(np.uint8)
    out[out_ends[long] - 1] = lb_vals

    cmap = np.zeros(256, dtype=bool)
    cmap[np.unique(chars)] = True
    if lb_vals.size:
        cmap[np.unique(lb_vals)] = True
    return out, cmap


def split_blocks(data: np.ndarray, max_block_size: int,
                 in_granul: int | None = -1) -> list[tuple[int, int]]:
    """Compute the (start, end) input spans of successive blocks, exactly
    reproducing the reference collector's fill rules.

    `in_granul`: input-buffer granularity.  The reference scheduler feeds
    each work block from a single input buffer of bs100k*100000 bytes
    (src/compress.c:91-103 — collect() is called once per work block),
    so block boundaries also fall on in_granul multiples.  The default
    (-1) uses max_block_size, matching the reference's default mode;
    None gives continuous boundaries (the reference's -u sequential-split
    mode, src/compress.c:120-198).
    """
    n = int(data.size)
    if in_granul == -1:
        in_granul = max_block_size
    if in_granul is None:
        in_granul = n or 1
    spans: list[tuple[int, int]] = []
    for wstart in range(0, n, in_granul):
        wend = min(wstart + in_granul, n)
        spans.extend(_split_window(data, wstart, wend, max_block_size))
    return spans


def _split_window(data: np.ndarray, wstart: int, wend: int,
                  max_block_size: int) -> list[tuple[int, int]]:
    """Capacity-based block splitting within one input window."""
    spans: list[tuple[int, int]] = []
    starts, lengths, chars = find_runs(data[wstart:wend])
    starts = starts + wstart
    run_ends = starts + lengths
    cum_out = np.cumsum(run_out_lengths(lengths))

    pos = wstart
    n = wend
    while pos < n:
        # Index of the run containing `pos`.
        r = int(np.searchsorted(run_ends, pos, side="right"))
        used = 0  # output bytes so far in this block
        begin = pos

        # Partial first run (block boundary split a run): remainder
        # re-enters RLE1 as a fresh run of the same char.
        full_block = False
        if pos > starts[r]:
            rem_len = int(run_ends[r] - pos)
            pos, used, full_block = _consume_run(
                pos, rem_len, used, max_block_size)
            if not full_block:
                r += 1
        if not full_block and r < starts.size:
            # Whole runs that certainly fit: cumulative output <= capacity.
            base_out = int(cum_out[r - 1]) if r > 0 else 0
            cap = max_block_size - used
            # Last run index m with cum_out[m] - base_out <= cap.
            m = int(np.searchsorted(cum_out, base_out + cap, side="right"))
            if m > r:
                stop = min(m, starts.size)
                used += int((cum_out[stop - 1] if stop > 0 else 0) - base_out)
                pos = int(run_ends[stop - 1])
                r = stop
            if used == max_block_size:
                full_block = True
            elif r < starts.size:
                # Boundary run: handle piece-by-piece with exact rules.
                run_len = int(lengths[r])
                pos, used, full_block = _consume_run(
                    pos, run_len, used, max_block_size)

        spans.append((begin, pos))
        if pos >= n:
            break
    return spans


def _consume_run(pos: int, run_len: int, used: int,
                 mbs: int) -> tuple[int, int, bool]:
    """Consume one run (possibly chunked at 259) against remaining block
    capacity.  Returns (new_pos, new_used, block_full)."""
    left = run_len
    while left > 0:
        r = min(left, _CHUNK)
        cap = mbs - used
        assert cap >= 1
        if r < 4:
            if r >= cap:
                # Literal writes fill the block exactly (full flagged when
                # the write hits mbs).
                return pos + cap, mbs, True
            pos += r
            used += r
            left -= r
            continue
        # r >= 4: needs up to 5 output bytes.
        if cap <= 3:
            return pos + cap, used + cap, True
        if cap == 4:
            # state-3 reservation: 3 chars written, 4th slot left empty,
            # block closed (src/encode.c:218-221).
            return pos + 3, used + 3, True
        # cap >= 5: whole piece fits (4 literals + length byte).
        pos += r
        used += 5
        left -= r
        if used == mbs:
            return pos, used, True
    return pos, used, False


def rle1_blocks(data: np.ndarray, max_block_size: int,
                in_granul: int | None = -1) -> list[BlockSpan]:
    """Split input into blocks and RLE1-transform each."""
    out = []
    for a, b in split_blocks(data, max_block_size, in_granul):
        blk, cmap = transform_span(data[a:b])
        assert blk.size <= max_block_size
        out.append(BlockSpan(a, b, blk, cmap))
    return out


def rle1_decode(data: np.ndarray) -> tuple[np.ndarray, bool]:
    """Inverse RLE1 (decoder-side 'emit' spec, src/decode.c:944-1144),
    vectorized: every 4-run is followed by a length byte.

    Returns (decoded, ok); ok=False iff the stream ends with a 4-run
    whose length byte is missing (reference ERR_RUNLEN)."""
    if data.size == 0:
        return data, True
    n = data.size
    # Detect positions where a run of 4 equal bytes ends: data[i-3..i] equal.
    eq = np.zeros(n, dtype=bool)
    if n >= 4:
        e1 = data[1:] == data[:-1]
        run4 = e1[:-2] & e1[1:-1] & e1[2:]  # data[i]==..==data[i+3]
        eq[3:] = run4
    # A length byte is the byte following a 4-run, but 4-runs cannot
    # overlap a previous length byte: scan runs of `eq`.
    is_len_byte = np.zeros(n, dtype=bool)
    repeat = np.ones(n, dtype=np.int64)
    ok = True
    # Sequential pass only over 4-run candidates (rare); use flatnonzero.
    cand = np.flatnonzero(eq)
    ptr = 0
    while ptr < cand.size:
        i = int(cand[ptr])
        # run of 4 ending at i -> next byte is length
        if i + 1 < n:
            is_len_byte[i + 1] = True
            repeat[i + 1] = 0
            repeat[i] = 1 + int(data[i + 1])
            # skip candidates inside [i+1, i+4] (they overlap the len byte)
            nxt = i + 2
            while ptr < cand.size and cand[ptr] < nxt + 3:
                ptr += 1
        else:
            # 4-run at end of block with no length byte (ERR_RUNLEN).
            ok = False
            ptr += 1
    vals = data[~is_len_byte]
    reps = repeat[~is_len_byte]
    return np.repeat(vals, reps), ok
