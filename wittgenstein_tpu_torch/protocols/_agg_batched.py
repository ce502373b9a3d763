"""Shared machinery for batched bitset-aggregation protocols (Handel, GSF).

Ported from the JAX package's protocols/_agg_batched.py; its docstring
tells the design in full.  In short: per-node contribution bitsets live
in the XOR-relative layout (ops.bitops), level l is the static bit block
[2^(l-1), 2^l), and re-addressing sender s's level-l content into
receiver i's space is the bit permutation j -> j ^ r0 with
r0 = (i^s) & (2^(l-1)-1).  The in-flight channel keeps, per (receiver,
level), D arrival-keyed slots (earliest arrival wins; slot = arrival mod
D) plus one freshest-offer backstop slot; content is re-addressed into
the receiver's space at send time; displacements are counted in
proto["displaced"].  Levels of equal word width share a WIDTH BUCKET and
every per-level computation runs once per bucket on a stacked level axis.
Keys pack (absolute_arrival << rel_bits) | rel.

Port notes: every state tensor carries the replica axis R in front
([R, N, ...]); helpers that only index the trailing axes are rank-agnostic
so proto_init can use them on a single replica.  Words are int32 bit views
of the JAX package's uint32.  Small static tables live on the state's
device once (`_tab`), so no tick copies from the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..engine.protocol import BatchedProtocol
from ..ops.bitops import lowest_set_bit, xor_shuffle
from ..ops.indexing import add_at, set_rows

INT32_MAX = 2**31 - 1
MAX_NODES = 1 << 14  # int32 key-packing headroom


@dataclasses.dataclass(frozen=True)
class Bucket:
    """A run of consecutive levels sharing one word width."""

    levels: tuple  # level numbers, ascending
    w_pad: int  # word width of the bucket's levels

    @property
    def lo(self) -> int:
        return self.levels[0]

    @property
    def hi(self) -> int:
        return self.levels[-1]

    @property
    def nl(self) -> int:
        return len(self.levels)


def _u32_i32(x64: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 with the same bits."""
    return (x64 & 0xFFFFFFFF).to(torch.int32)


class BitsetAggBase(BatchedProtocol):
    TICK_INTERVAL = 1  # verification capacity is modeled per-ms
    PAYLOAD_WIDTH = 0  # messaging bypasses the generic store entirely
    CHANNEL_DEPTH = 8  # D: arrival-keyed in-flight slots per (receiver, level)
    BEAT_SEND_CALLS = 1  # _dissemination makes one stacked send

    def tick_beat(self, net, state, t: int):
        """Periodic dissemination as the engine's beat hook, inside the
        NARROW_LEAVES widen/narrow boundary."""
        state = state._replace(proto=self.widen_proto(state.proto))
        state = self._dissemination(net, state, t)
        return state._replace(proto=self.narrow_proto(state.proto))

    def _init_geometry(self, n: int) -> None:
        if n & (n - 1):
            raise ValueError("power-of-two node counts only")
        if n > MAX_NODES:
            raise NotImplementedError(
                f"node_count {n} > {MAX_NODES}: int32 channel/sort key packing "
                "would overflow; widen the keys before raising this cap"
            )
        self.n_nodes = n
        self.n_words = max(1, n // 32)
        self.n_levels = n.bit_length()  # levels 0..log2(n)
        self.rel_bits = max(1, (n - 1).bit_length())
        self.MSG_TYPES = [f"SIGS_L{l}" for l in range(self.n_levels)]

        # per-level content geometry: level l's payload is bits [0, 2^(l-1))
        # = w_l exact words; bs_l = block size in bits
        self.w = [0] * self.n_levels
        self.bs = [0] * self.n_levels
        for l in range(1, self.n_levels):
            self.bs[l] = 1 << (l - 1)
            self.w[l] = max(1, (1 << (l - 1)) // 32)
        self.w_max = self.w[self.n_levels - 1] if self.n_levels > 1 else 1

        # exact-width buckets over levels 1..L-1
        buckets = []
        for l in range(1, self.n_levels):
            if buckets and buckets[-1][1] == self.w[l]:
                buckets[-1][0].append(l)
            else:
                buckets.append([[l], self.w[l]])
        self.buckets = [Bucket(tuple(lv), wp) for lv, wp in buckets]

        # static per-level tables (stacked [L-1] vectors, level-1 at index 0)
        self.lv_w = np.asarray(self.w[1:], np.int32)  # exact widths
        self.lv_bs = np.asarray(self.bs[1:], np.int32)  # block sizes
        self._host_tabs = {
            "lv_w": self.lv_w,
            "lv_bs": self.lv_bs,
            "lv_all": np.arange(1, self.n_levels, dtype=np.int32),
            "empty_tpl": np.where(self._fresh_cols(), -1, INT32_MAX).astype(np.int32),
            "sizes": self._size_table(),
        }
        for i, b in enumerate(self.buckets):
            self._host_tabs[f"b{i}_lv"] = np.asarray(b.levels, np.int32)
            self._host_tabs[f"b{i}_bs"] = np.asarray([self.bs[l] for l in b.levels], np.int32)
        self._dev_tabs = {}

    def _tab(self, name: str, device) -> torch.Tensor:
        """Static table `name` on `device`, uploaded once."""
        key = (name, str(device))
        if key not in self._dev_tabs:
            self._dev_tabs[key] = torch.as_tensor(self._host_tabs[name], device=device)
        return self._dev_tabs[key]

    # -- stacked block views -------------------------------------------------
    # Full-width [.., W] layout is the concatenation of level blocks:
    # word 0 = bit 0 (level 0) + sub-word blocks of levels with bs < 32;
    # each level with bs >= 32 owns words [bs/32, 2bs/32).

    def _blocks(self, x, b: Bucket):
        """Bucket view of full-width vectors: [.., W] -> [.., nl, w_pad]."""
        outs = []
        for l in b.levels:
            bs = self.bs[l]
            if bs < 32:
                # the mask keeps the block's bits, so the arithmetic shift's
                # sign extension never survives
                blk = (x[..., 0:1] >> bs) & ((1 << bs) - 1)
            else:
                blk = x[..., bs // 32 : (2 * bs) // 32]
            outs.append(blk)
        return torch.stack(outs, dim=-2)

    def _lows(self, x, b: Bucket):
        """Bucket view of sender-space outgoing content (bits [0, 2^(l-1)))
        per level: [.., W] -> [.., nl, w_pad]."""
        outs = []
        for l in b.levels:
            bs = self.bs[l]
            if bs < 32:
                blk = x[..., 0:1] & ((1 << bs) - 1)
            else:
                blk = x[..., : bs // 32]
            outs.append(blk)
        return torch.stack(outs, dim=-2)

    def _assemble(self, x_old, pieces):
        """Rebuild full-width vectors from per-bucket block stacks
        ([.., nl, w_pad] each); level-0's bit 0 is kept from x_old."""
        word0 = x_old[..., 0] & 1
        tail = []
        for b, pc in zip(self.buckets, pieces):
            for j, l in enumerate(b.levels):
                bs, w = self.bs[l], self.w[l]
                blk = pc[..., j, :w]
                if bs < 32:
                    word0 = word0 | (blk[..., 0] << bs)
                else:
                    tail.append(blk)
        return torch.cat([word0[..., None]] + tail, dim=-1)

    def _level_stats(self, per_bucket):
        """Concat per-bucket [.., nl] level-axis stats into [.., L-1]."""
        return torch.cat(per_bucket, dim=-1)

    def _dyn_low(self, x, level, b: Bucket):
        """Sender-space outgoing content at a DYNAMIC per-node level
        (valid where level is inside bucket b): [.., W], [..] -> [.., w_pad]."""
        dev = x.device
        lv = (torch.clamp(level, 1, self.n_levels - 1) - 1).to(torch.int64)
        bs = self._tab("lv_bs", dev)[lv]
        w = self._tab("lv_w", dev)[lv]
        out = x[..., : b.w_pad]
        if b.w_pad == 1 and self.bs[b.lo] < 32:
            # sub-word levels: bits [0, bs) of word 0 (bs may be 32)
            m = (torch.ones_like(bs, dtype=torch.int64) << (bs & 31)) - 1
            m = torch.where(bs >= 32, -1, _u32_i32(m))
            return out & m[..., None]
        keep = torch.arange(b.w_pad, dtype=torch.int32, device=dev) < w[..., None]
        return torch.where(keep, out, 0)

    # -- misc bit helpers ----------------------------------------------------
    @staticmethod
    def _onehot(r0, w: int):
        """Block-local one-hot bit r0: [...] int32 -> [..., w] int32 words."""
        word = r0 >> 5
        bit = r0 & 31
        oh = torch.ones_like(bit) << bit  # bit 31 lands on the sign bit
        ar = torch.arange(w, dtype=torch.int32, device=r0.device)
        return torch.where(ar == word[..., None], oh[..., None], 0)

    @staticmethod
    def _lowest_bit(words):
        """Index of the lowest set bit over the last axis of packed [..., w]
        int32 words (32 when empty — gate on popcount > 0); shared with the
        engine's wheel-occupancy scan."""
        return lowest_set_bit(words)

    def _getbit(self, x, pos):
        """Bit `pos` of full-width [R, N, W] vectors; pos is [R, N, ...]."""
        lead = pos.shape[:2]
        word = torch.gather(
            x, -1, (pos >> 5).reshape(lead + (-1,)).to(torch.int64)
        ).reshape(pos.shape)
        return (word >> (pos & 31)) & 1

    # -- channel layout ------------------------------------------------------
    # in_key: [.., N, (L-1)*(D+1)] packed (arrival<<rel_bits | rel);
    # content per bucket i: proto[f"in_sig{i}"] = [.., N, nl*(D+1)*w_pad]
    # flat, level-major then slot then word.

    def _fresh_cols(self) -> np.ndarray:
        """bool[(L-1)*(D+1)]: which in_key columns are fresh-backstop slots."""
        ss = self.CHANNEL_DEPTH + 1
        cols = np.zeros((self.n_levels - 1) * ss, dtype=bool)
        cols[ss - 1 :: ss] = True
        return cols

    def _keys_stacked(self, in_key):
        """[.., (L-1)*ss] -> [.., L-1, ss]."""
        ss = self.CHANNEL_DEPTH + 1
        return in_key.reshape(in_key.shape[:-1] + (self.n_levels - 1, ss))

    def _sig_view(self, proto, i: int, slots: int, prefix: str = "in_sig"):
        """Bucket i's content as [.., N, nl, slots, w_pad]."""
        b = self.buckets[i]
        a = proto[f"{prefix}{i}"]
        return a.reshape(a.shape[:-1] + (b.nl, slots, b.w_pad))

    def _channel_init(self, n: int, device):
        """Fresh in_key plus per-bucket in_sig arrays (fresh slots empty at
        -1, arrival slots at INT32_MAX) for one replica."""
        ss = self.CHANNEL_DEPTH + 1
        in_key = np.where(self._fresh_cols(), -1, INT32_MAX).astype(np.int32)
        sigs = {
            f"in_sig{i}": torch.zeros((n, b.nl * ss * b.w_pad), dtype=torch.int32, device=device)
            for i, b in enumerate(self.buckets)
        }
        keys = torch.as_tensor(np.broadcast_to(in_key, (n, in_key.size)).copy(), device=device)
        return keys, sigs

    def _advance_channel(self, in_key, t: int):
        """Due mask at tick t; returns (in_key, due, empty_tpl).  Keys pack
        the ABSOLUTE arrival, so the due test is a compare against t."""
        occupied = (in_key >= 0) & (in_key != INT32_MAX)
        due = occupied & ((in_key >> self.rel_bits) <= t)
        return in_key, due, self._tab("empty_tpl", in_key.device)

    # -- due-slot gather ------------------------------------------------------
    # Arrival slots are keyed slot = arrival mod D and a slot is due exactly
    # at its arrival tick, so at tick t the ONLY slots that can be due are
    # arrival slot (t mod D) and the fresh backstop.

    def _due_pair_keys(self, keys3, due3, t: int):
        """[.., L-1, ss] stacked keys/due -> the two due-able columns as
        [.., L-1, 2] (index 0 = arrival slot t mod D, 1 = fresh)."""
        d = self.CHANNEL_DEPTH
        sidx = int(np.fmod(t, d))  # lax.rem truncates toward zero
        return (
            torch.stack([keys3[..., sidx], keys3[..., d]], dim=-1),
            torch.stack([due3[..., sidx], due3[..., d]], dim=-1),
        )

    def _due_pair_sig(self, proto, i: int, t: int, prefix: str = "in_sig"):
        """Bucket i's content for the two due-able slots: [.., nl, 2, w_pad]."""
        d = self.CHANNEL_DEPTH
        sig = self._sig_view(proto, i, d + 1, prefix=prefix)
        sidx = int(np.fmod(t, d))
        return torch.stack([sig[..., sidx, :], sig[..., d, :]], dim=-2)

    # -- the stacked send path -----------------------------------------------
    def _send_stacked(self, net, state, t: int, mask, from_idx, to_idx, level, content,
                      aux=None):
        """Send M messages per replica (one per row, each at its own level)
        into the per-(receiver, level, slot) channel in ONE body: earliest
        arrival wins an arrival slot, the newest offer always takes the
        fresh slot.

        mask/to_idx/level: [R, M]; from_idx: [R, M] or [M]; level in
        [1, L-1]; content: list aligned with self.buckets of [R, M, w_pad]
        SENDER-space words, re-addressed into the receiver's block-local
        space here; aux: optional [R, M] int32 stored per slot in
        proto["in_aux"] (GSF's prefix k), written where the content is."""
        proto = state.proto
        d = self.CHANNEL_DEPTH
        ss = d + 1
        r, m = mask.shape
        n = self.n_nodes
        dev = mask.device
        from_idx = from_idx.to(torch.int32).expand(r, m)
        to_idx = to_idx.to(torch.int32)
        # masked rows may carry junk levels; clamp so every index is in range
        level = torch.clamp(level.to(torch.int32), 1, self.n_levels - 1)
        state, ok, arrival = net.latency_arrivals(state, mask, from_idx, to_idx, t + 1, level, t)
        # receiver traffic counters tick at send time (the JAX package's
        # _send_stacked explains why)
        okc = ok.to(torch.int32)
        sizes = self._tab("sizes", dev)[level.to(torch.int64)]
        state = state._replace(
            msg_received=add_at(state.msg_received, to_idx, okc),
            bytes_received=add_at(state.bytes_received, to_idx, okc * sizes),
        )
        rel = to_idx ^ from_idx
        # beyond the int32 packing horizon sends are dropped and counted
        # as displaced; strictly below the last in-horizon ms, where a
        # max-rel key would equal the INT32_MAX empty sentinel
        fits_t = arrival < (1 << (31 - self.rel_bits)) - 1
        time_overflow = (ok & ~fits_t).sum(-1).to(torch.int32)
        ok = ok & fits_t
        key = torch.where(ok, (arrival << self.rel_bits) | rel, INT32_MAX)
        slot = torch.fmod(arrival, d)  # lax.rem truncates

        # re-address sender-space content into the receiver's block-local
        # space (bit j -> j ^ r0) for all rows
        lv0 = (level - 1).to(torch.int64)
        bs_row = self._tab("lv_bs", dev)[lv0]
        cnt_list = []
        for i, b in enumerate(self.buckets):
            in_b = (level >= b.lo) & (level <= b.hi)
            r0 = torch.where(in_b, rel & (bs_row - 1), 0)
            cnt_list.append(xor_shuffle(content[i], r0))

        in_key = proto["in_key"]  # [R, N, C]
        c = in_key.shape[-1]
        rbase = (torch.arange(r, dtype=torch.int64, device=dev) * n)[:, None]
        row = rbase + to_idx.to(torch.int64)  # [R, M] flat (replica, receiver)
        col = lv0 * ss + slot.to(torch.int64)
        fcol = lv0 * ss + d
        flat = in_key.reshape(-1)
        kidx = row * c + col
        fidx = row * c + fcol
        prev = flat[kidx]
        # non-ok rows carry INT32_MAX (neutral for min) and -1 (neutral for
        # max: fresh slots hold -1 or a key), the stand-in for JAX's drop
        flat = flat.scatter_reduce(0, kidx.reshape(-1), key.reshape(-1), "amin")
        winner = ok & (flat[kidx] == key)
        flat = flat.scatter_reduce(
            0, fidx.reshape(-1), torch.where(ok, key, -1).reshape(-1), "amax"
        )
        fresh_win = ok & (flat[fidx] == key)
        new_key = flat.view(in_key.shape)

        # displacement accounting: an ok send that won neither slot, or a
        # winner that evicted a still-pending occupant with a later arrival
        lost_entry = ok & ~winner & ~fresh_win
        evicted = winner & (prev != INT32_MAX) & (prev > key)
        displaced = (lost_entry | evicted).sum(-1).to(torch.int32) + time_overflow

        updates = dict(proto, in_key=new_key, displaced=proto["displaced"] + displaced)
        for i, b in enumerate(self.buckets):
            in_b = (level >= b.lo) & (level <= b.hi)
            li = (level - b.lo).to(torch.int64)
            cw = torch.arange(b.w_pad, dtype=torch.int64, device=dev)
            a = updates[f"in_sig{i}"]
            ca = a.shape[-1]
            cols = ((li * ss + slot.to(torch.int64)) * b.w_pad)[..., None] + cw
            fcols = ((li * ss + d) * b.w_pad)[..., None] + cw
            # one write for both slots: winners' arrival columns and fresh
            # winners' backstop columns never coincide (slot < d)
            pos = torch.cat([row[..., None] * ca + cols, row[..., None] * ca + fcols], 1)
            keep = torch.cat([in_b & winner, in_b & fresh_win], 1)
            vals = torch.cat([cnt_list[i], cnt_list[i]], 1)
            updates[f"in_sig{i}"] = set_rows(
                a, pos.reshape(-1, b.w_pad), vals.reshape(-1, b.w_pad), keep.reshape(-1)
            )
        if aux is not None:
            aux = aux.to(torch.int32).expand(r, m)
            updates["in_aux"] = set_rows(
                proto["in_aux"],
                torch.cat([kidx, fidx], 1).reshape(-1, 1),
                torch.cat([aux, aux], 1).reshape(-1, 1),
                torch.cat([winner, fresh_win], 1).reshape(-1),
            )
        return state._replace(proto=updates)

    # -- entry-identity candidate clears -------------------------------------
    @staticmethod
    def _entry_clear(cur_id3, cur_card3, tgt_id3, tgt_card3, tgt_mask3):
        """[.., L-1, K] clear mask: current entries equal in (id,
        cardinality) to any masked target entry of the same level."""
        m = (
            (cur_id3[..., :, None] == tgt_id3[..., None, :])
            & (cur_card3[..., :, None] == tgt_card3[..., None, :])
            & tgt_mask3[..., None, :]
        )
        return torch.any(m, dim=-1)

    @staticmethod
    def _remove_chosen(id3, card3, lvl_idx, sel_id, sel_card, remove):
        """Clear the chosen entry from its level's CURRENT slots by (id,
        cardinality) identity; returns the updated [R, N, L-1, K] ids."""
        r, n, _, k = id3.shape
        li = lvl_idx.to(torch.int64)[..., None, None].expand(r, n, 1, k)
        row_id = torch.gather(id3, 2, li)[:, :, 0]
        row_card = torch.gather(card3, 2, li)[:, :, 0]
        mrow = (
            remove[..., None]
            & (row_id == sel_id[..., None])
            & (row_card == sel_card[..., None])
        )
        new_row = torch.where(mrow, INT32_MAX, row_id)
        return id3.scatter(2, li, new_row[:, :, None, :])

    def _size_table(self):
        return np.asarray([self.msg_size(t) for t in range(self.n_levels)], np.int32)
