"""Host-side packing of the paged KV cache's per-step paging arrays.

The numpy page builders of ``repro.serving.kvcache``, copied: block
tables, valid lengths and write destinations packed per step, so
continuous batching, migration and recovery are pure data to the decode
step.  The device-side pools live in the model's paged cache
(``Model.init_paged_cache``) and are attended through
``kernels.ops.paged_attention``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def max_blocks_per_seq(max_seq: int, block_size: int) -> int:
    return (max_seq + block_size - 1) // block_size


def table_array(tables: Dict[int, "BlockTable"], order: List[int],
                max_blk: int) -> np.ndarray:
    """Pack host-side block tables into the (B, max_blk) device array."""
    out = np.zeros((len(order), max_blk), np.int32)
    for i, seq_id in enumerate(order):
        blocks = tables[seq_id].blocks
        out[i, : len(blocks)] = blocks[:max_blk]
    return out


def build_page_context(decode_reqs, block_tables, *, max_batch: int,
                       max_blk: int, block_size: int,
                       trash_block: int) -> Dict[str, np.ndarray]:
    """The per-step paging arrays for one decode batch.

    For each request in ``decode_reqs`` (occupying ``req.batch_slot``),
    position ``num_tokens - 1`` is where this step's incoming token
    lands; ``seq_lens`` is the valid length including it.  Idle batch
    slots keep seq_len 0 and write into the trash block, so a full-width
    decode step never touches live blocks.
    """
    tables = np.zeros((max_batch, max_blk), np.int32)
    seq_lens = np.zeros((max_batch,), np.int32)
    write_bid = np.full((max_batch,), trash_block, np.int32)
    write_off = np.zeros((max_batch,), np.int32)
    for req in decode_reqs:
        slot = req.batch_slot
        blocks = block_tables[req.req_id].blocks
        tables[slot, : len(blocks)] = blocks[:max_blk]
        wp = req.num_tokens - 1              # position of the new token
        seq_lens[slot] = wp + 1
        write_bid[slot] = blocks[wp // block_size]
        write_off[slot] = wp % block_size
    return {"tables": tables, "seq_lens": seq_lens,
            "write_bid": write_bid, "write_off": write_off}


def build_chunk_context(pieces, block_tables, *, width: int, max_blk: int,
                        block_size: int, trash_block: int):
    """Pack a batched multi-request prefill chunk into paging arrays.

    A chunked prefill step is a decode step over ``width`` *virtual
    slots*: row ``r`` carries one prompt token, its owner's block table,
    ``seq_lens`` = its absolute position + 1 (so causal attention over
    the pool covers the already-installed prefix AND earlier rows of the
    same chunk, whose K/V land in the pool before attention runs), and
    the (block, offset) its own K/V is written to.  Requests of any
    length mix freely in one chunk — raggedness is pure data, so the
    compiled graph never re-specializes.  Rows past the planned tokens
    are idle: seq_len 0, writes into the trash block.

    ``pieces``: objects with ``.req`` (owning Request), ``.start``
    (first position this step), ``.length`` and ``.tokens`` (the full
    token sequence being prefilled).  Returns ``(tokens, page)``.
    """
    tokens = np.zeros((width,), np.int32)
    tables = np.zeros((width, max_blk), np.int32)
    seq_lens = np.zeros((width,), np.int32)
    write_bid = np.full((width,), trash_block, np.int32)
    write_off = np.zeros((width,), np.int32)
    row = 0
    for piece in pieces:
        blocks = block_tables[piece.req.req_id].blocks
        packed = np.asarray(blocks[:max_blk], np.int32)
        for j in range(piece.length):
            pos = piece.start + j
            tokens[row] = piece.tokens[pos]
            tables[row, : len(packed)] = packed
            seq_lens[row] = pos + 1
            write_bid[row] = blocks[pos // block_size]
            write_off[row] = pos % block_size
            row += 1
    assert row <= width, (row, width)
    page = {"tables": tables, "seq_lens": seq_lens,
            "write_bid": write_bid, "write_off": write_off}
    return tokens, page


def padded_block_ids(blocks: List[int], nblk: int,
                     trash_block: int) -> np.ndarray:
    """A request's block ids padded to the prefill bucket's block count;
    ids past the table point at the trash block (their rows are dead)."""
    out = np.full((nblk,), trash_block, np.int32)
    out[: min(len(blocks), nblk)] = blocks[:nblk]
    return out
