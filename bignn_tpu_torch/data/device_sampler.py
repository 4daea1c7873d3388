"""Device-resident hierarchical sampling (counterpart of
``bignn_tpu/data/device_sampler.py``; config4).

The whole per-step draw runs on the card in PyTorch, with static shapes and
no host synchronisation, so an epoch of ``MinibatchTrainer`` with
``device_sample`` needs no host work per step. The pipeline is the JAX
package's, step for step:
  1. positive pair draw + negative endpoint corruption;
  2. L-hop fanout neighbour expansion over the resident train-graph CSR
     (the whole neighbourhood when the degree is at most the fanout, else a
     random contiguous window of the once-shuffled neighbour list);
  3. sort-based dedup per hop (one sort over the kept nodes and the
     candidates) + seed-preserving budget truncation; hops past the first
     whose budget is always saturated add edges only
     (``_calibrate_node_hops``, NumPy at init);
  4. the class-packed block layout: molecules by quantized size class,
     stable ranks from a one-hot cumsum, fillers of a smaller class in each
     block's leftover rows, closed-form offsets and slots;
  5. the outer subgraph: canonical-pair dedup of the sampled tree edges,
     both directions + live self-loops, stably sorted by (dst, src), and the
     source-sort permutation for free as the mirror involution of that
     symmetric list.

What differs from JAX: the draws come from a ``torch.Generator`` on the
sampler's device, reseeded for each step from (seed, epoch, step)
(``key_at``), so a batch is a pure function of them (resume is exact), but
not JAX's threefry draws: the tests compare invariants and distributions.
Composite sort keys are int64 (``lo * (D + 1) + hi``, ``dst * (D + 1) +
src``, ``owner * 2**31 + r``), where JAX sorts on two keys, so no key can
overflow. A window of the neighbour list is taken with ``torch.gather``
(the JAX package selects it with a one-hot sum, the same values).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SamplerConsts(NamedTuple):
    """Device-resident constants (uploaded once, ~O(E) int32)."""

    adj_ptr: torch.Tensor  # [N+1] int32 undirected train-graph CSR
    adj_dst: torch.Tensor  # [E16/16, 16] int32 SHUFFLED neighbour lists
    train_pairs: torch.Tensor  # [T, 2] int32 positive train edges
    qn: torch.Tensor  # [N] int32 quantized molecule node counts
    qe: torch.Tensor  # [N] int32 quantized molecule edge counts
    cls_of_size: torch.Tensor  # [max_qn+1] int32 size -> class id
    class_size: torch.Tensor  # [C] int32 ascending distinct quantized sizes
    class_pb: torch.Tensor  # [C] int32 molecules per 128-row block
    fpb: torch.Tensor  # [C] int32 filler molecules per block of a class
    client_mask: torch.Tensor  # [C, C] bool: class c fills blocks of g

    def to(self, device) -> "SamplerConsts":
        return SamplerConsts(*(torch.as_tensor(x).to(device) for x in self))


class DeviceSampler:
    """Sampler of whole batches on the card, built over a calibrated
    ``HierarchicalSampler``.

    Reuses the host sampler's caps (drug_budget/node_cap/edge_cap/
    outer_edge_cap, including its empirical calibration) and its molecule
    tables; only the per-step draw moves to the device. Requires the
    block-local quantized layout (the class packer needs molecules <= 128
    rows).
    """

    def __init__(self, host_sampler):
        s = host_sampler
        if not getattr(s, "block_local", False):
            raise ValueError(
                "DeviceSampler requires the block-local layout "
                "(molecules <= 128 rows); use the host sampler otherwise")
        self.host = s
        self.N = int(s.num_nodes)
        self.D = int(s.drug_budget)
        self.NC = int(s.node_cap)
        self.EC = int(s.edge_cap)
        self.OE = int(s.outer_edge_cap)
        self.batch_size = int(s.batch_size)
        self.neg_ratio = int(s.neg_ratio)
        self.pair_cap = int(s.pair_cap)
        self.fanouts = tuple(int(f) for f in s.fanouts)
        self.r_node = int(s.r_node)
        self.T = int(len(s.train_pairs))
        self.seed = int(s.seed)
        # Window sampling draws a contiguous window spanning at most two
        # aligned 16-rows, so each hop's fanout must be <= 16; validate at
        # construction, not at the first draw.
        if any(f > 16 for f in self.fanouts):
            raise ValueError(
                f"window sampling supports fanout <= 16 per hop, got "
                f"fanouts={self.fanouts}; use the host sampler (or split "
                "the hop) for wider fanouts")
        # per-hop frontier caps: seeds, then min(D, prev*fanout)
        caps = [min(self.pair_cap * 2, max(self.D, 1))]
        for f in self.fanouts:
            caps.append(min(self.D, caps[-1] * f))
        self.fcaps = caps
        # edge-only trailing hops (module docstring, step 3): the NumPy
        # calibration finds the first hop after which the drug budget is
        # ALWAYS saturated with margin; later hops skip dedup/budget (they
        # can only contribute outer edges), and hops past the first
        # edge-only hop are statically skipped (their frontier would be
        # all-sentinel, so they would draw no candidates anyway).
        qn = np.diff(s._mol_qptr).astype(np.int32)
        sizes = np.unique(qn[qn > 0])
        if sizes.size == 0 or int(sizes.max()) > 128:
            raise ValueError("class packer needs 0 < quantized size <= 128")
        cls_of_size = np.zeros(int(sizes.max()) + 1, np.int32)
        cls_of_size[sizes] = np.arange(len(sizes), dtype=np.int32)
        self.C = int(len(sizes))
        self._qn_np = qn
        self._cls_of_size_np = cls_of_size
        self._class_pb_np = (128 // sizes).astype(np.int32)
        self._class_size_np = sizes.astype(np.int32)
        # MIXED-CLASS packing statics: each class c's per-block leftover
        # (128 - pb_c*s_c) hosts fillers of the LARGEST smaller class
        # whose size fits (gidx[c]; -1 when none fits). fpb[c] = fillers
        # per class-c block; client_mask[g, c] marks c as a client of g.
        C0 = len(sizes)
        leftover = 128 - self._class_pb_np * self._class_size_np
        gidx = np.full(C0, -1, np.int32)
        fpb = np.zeros(C0, np.int32)
        for c in range(C0):
            fits_g = np.flatnonzero(
                (self._class_size_np[:c] <= leftover[c]))
            if len(fits_g):
                g = int(fits_g[-1])
                gidx[c] = g
                fpb[c] = leftover[c] // self._class_size_np[g]
        self._gidx_np = gidx
        self._fpb_np = fpb
        self._client_mask_np = (
            gidx[None, :] == np.arange(C0, dtype=np.int32)[:, None])

        # WINDOW SAMPLING layout: each node's neighbor list is shuffled
        # ONCE (deterministic in seed) and stored as 16-aligned int32 rows.
        # A fanout draw then takes a random CONTIGUOUS window of the
        # shuffled list — two aligned row gathers — instead of `fanout`
        # independent element gathers. See sample() for the estimator
        # notes. Built BEFORE the node-hop calibration so the calibration
        # can simulate the REAL window-draw semantics over the same
        # shuffled lists.
        rng_sh = np.random.default_rng((self.seed, 0x5FFE))
        _deg = np.diff(s._adj_ptr)
        _owner = np.repeat(np.arange(self.N, dtype=np.int64), _deg)
        _order = np.lexsort((rng_sh.random(len(s._adj_dst)), _owner))
        _adj_sh = np.asarray(s._adj_dst, np.int32)[_order]
        self._adj_sh_np = _adj_sh
        _e16 = -(-len(_adj_sh) // 16) * 16
        _adj2d = np.zeros(_e16, np.int32)
        _adj2d[: len(_adj_sh)] = _adj_sh
        self._adj2d_np = _adj2d

        self.n_node_hops, nc_dev = self._calibrate_node_hops(s)
        # DEVICE-CALIBRATED node cap: the host NC was calibrated against
        # the host greedy first-fit packer; the class packer's extent is
        # closed-form in the per-class counts and tighter (config4: 448,512
        # rows). Every NC-proportional step cost (block-adjacency build,
        # inner MLP matmuls, expansion writes and feature-gather rows)
        # shrinks with it.
        # Overflow beyond the calibrated max stays a counted suffix
        # truncation (ncap_dropped), exactly like the host's statistical
        # caps.
        self.NC = min(self.NC, nc_dev)
        self.active_hops = min(len(self.fanouts), self.n_node_hops + 1)
        # undirected dedup cap: su/sv = both directions + D self loops must
        # fit the host-calibrated outer_edge_cap exactly; also bounded by
        # the total sampled-edge buffer (on small graphs the calibrated OE
        # can exceed every edge the hops could possibly produce)
        e_total = sum(self.fcaps[h] * self.fanouts[h]
                      for h in range(self.active_hops))
        self.U = max(min((self.OE - self.D) // 2, e_total), 1)
        if 2 * self.U + self.D > self.OE:
            raise ValueError(
                f"outer_edge_cap {self.OE} cannot hold {self.D} self-loops "
                "plus one undirected pair in both directions")
        self.idt = (torch.int16 if self.D <= np.iinfo(np.int16).max
                    else torch.int32)

        qn = self._qn_np
        qe = np.diff(s._tbl_eptr).astype(np.int32)
        cls_of_size = self._cls_of_size_np
        sizes = np.unique(qn[qn > 0])
        self._consts_np = SamplerConsts(
            adj_ptr=s._adj_ptr.astype(np.int32),
            adj_dst=self._adj2d_np.reshape(-1, 16),
            train_pairs=s.train_pairs.astype(np.int32),
            qn=qn,
            qe=qe,
            cls_of_size=cls_of_size,
            class_size=sizes.astype(np.int32),
            class_pb=(128 // sizes).astype(np.int32),
            fpb=self._fpb_np,
            client_mask=self._client_mask_np,
        )
        self._generators: dict = {}

    def constants(self) -> SamplerConsts:
        """NumPy constants; callers upload them once (``.to(device)``)."""
        return self._consts_np

    def reshuffle_adj(self, consts: SamplerConsts,
                      epoch: int) -> SamplerConsts:
        """Epoch-fresh segmented shuffle of the neighbour lists, a pure
        function of (seed, epoch); epoch 0 = the init shuffle. Opt-in
        (``TrainConfig.reshuffle_epochs``): the JAX package measured it
        hurting learning at config4 as a default. One sort of the flat
        adjacency by (owner, fresh random), owners from the CSR pointers by
        a scatter-max and a running max, padding forced to the tail."""
        if int(epoch) == 0:
            return consts
        flat = consts.adj_dst.reshape(-1)
        dev = flat.device
        e16 = flat.shape[0]
        e = int(self.host._adj_dst.shape[0])
        starts = torch.zeros(e16 + 1, dtype=torch.int64, device=dev)
        starts.scatter_reduce_(
            0, consts.adj_ptr[:-1].long(),
            torch.arange(self.N, dtype=torch.int64, device=dev), "amax")
        owner = torch.cummax(starts[:e16], 0).values
        owner = torch.where(torch.arange(e16, device=dev) < e, owner, self.N)
        gen = self._generator(dev)
        gen.manual_seed(_mix(self.seed ^ 0x5FFE, int(epoch)))
        r = torch.randint(0, 2**31 - 1, (e16,), generator=gen, device=dev)
        order = torch.sort(owner * 2**31 + r, stable=True).indices
        return consts._replace(adj_dst=flat[order].reshape(-1, 16))

    def key_at(self, epoch: int, step: int) -> int:
        """The (seed, epoch, step)-derived seed of a step's generator."""
        return _mix(self.seed, int(epoch), int(step))

    def _generator(self, device) -> torch.Generator:
        device = torch.device(device)
        if device not in self._generators:
            self._generators[device] = torch.Generator(device=device)
        return self._generators[device]

    def _calibrate_node_hops(self, s, draws: int = 12,
                             margin: float = 1.3) -> tuple[int, int]:
        """(node hops, device-calibrated node cap).

        Node hops: the number of hops that must run the node-adding
        (dedup + budget) path; trailing hops are edge-only — the smallest h
        such that after hop h-1 the drug budget D was saturated in EVERY
        draw with ``margin``x more unique candidates available than budget
        remained. Node cap: the max CLASS-PACK extent (sum_c 128 *
        ceil(n_c / pb_c) over the kept node set) across the simulated
        draws, with 5% + one-block headroom. Simulates ``draws`` full
        hierarchical draws in NumPy with the REAL window-draw semantics:
        contiguous windows of the once-shuffled neighbor lists
        (without replacement), full neighborhood when deg <= fanout,
        ascending-unique budget truncation — the same draw distribution
        sample() runs, so the calibrated extent is an unbiased max over
        simulated real draws rather than an iid-with-replacement proxy.
        The simulation applies no edge-cap, which can only OVERestimate
        the packed extent (edge-cap removes molecules before packing) —
        conservative for a cap. Statistics only — no coupling to the
        device RNG streams; deterministic in (seed, dataset), so resume
        and cross-process draws stay exact. Persistent nonzero
        ncap_dropped at train time is surfaced as a warning by
        MinibatchTrainer (trunc_ncap_dropped counter)."""
        ptr = np.asarray(s._adj_ptr, np.int64)
        adj_sh = np.asarray(self._adj_sh_np, np.int64)
        tp = np.asarray(s.train_pairs, np.int64)
        H = len(self.fanouts)
        rng = np.random.default_rng(self.seed + 0x5EED)
        sat = np.full(H, True)
        max_ext = 0
        for _ in range(draws):
            bs = self.batch_size
            pos = tp[rng.integers(0, len(tp), bs)]
            endpoints = [pos.reshape(-1)]
            for _ in range(self.neg_ratio):
                right = rng.random(bs) < 0.5
                rand = rng.integers(0, self.N, bs)
                endpoints.append(np.where(right, pos[:, 0], rand))
                endpoints.append(np.where(right, rand, pos[:, 1]))
            seeds = np.unique(np.concatenate(endpoints))
            seen = np.zeros(self.N, bool)
            seen[seeds] = True
            total = min(len(seeds), self.D)
            frontier = seeds[: self.fcaps[0]]
            for h in range(H):
                f = self.fanouts[h]
                deg = ptr[frontier + 1] - ptr[frontier]
                # mirror sample()'s window rule: uniform start in
                # [0, deg-f], contiguous window of the shuffled list;
                # whole neighborhood when deg <= f
                start = (rng.random(len(frontier))
                         * np.maximum(deg - f + 1, 1)).astype(np.int64)
                start = np.where(deg <= f, 0, start)
                cols = start[:, None] + np.arange(f)[None, :]
                ev = np.arange(f)[None, :] < deg[:, None]
                cand = adj_sh[np.minimum(ptr[frontier][:, None] + cols,
                                         len(adj_sh) - 1)][ev]
                cand = np.unique(cand[~seen[cand]])
                rem = self.D - total
                keep = min(len(cand), rem)
                sat[h] &= (total + keep >= self.D) and (
                    len(cand) >= margin * max(rem, 1))
                newf = cand[:keep]
                seen[newf] = True
                total += keep
                frontier = newf[: self.fcaps[h + 1]]
            kept = np.flatnonzero(seen)[: self.D]
            cls = self._cls_of_size_np[self._qn_np[kept]]
            cnt = np.bincount(cls, minlength=self.C)
            # mixed-class extent: mirror of sample()'s descending-order
            # resolution (a class's filler demand comes only from larger
            # classes)
            pbn = self._class_pb_np
            fpbn = self._fpb_np
            gx = self._gidx_np
            blocks = np.zeros(self.C, np.int64)
            for c in range(self.C - 1, -1, -1):
                demand = sum(int(blocks[c2]) * int(fpbn[c2])
                             for c2 in range(c + 1, self.C)
                             if gx[c2] == c)
                own_c = int(cnt[c]) - min(int(cnt[c]), demand)
                blocks[c] = -(-own_c // int(pbn[c]))
            ext = int(128 * blocks.sum())
            max_ext = max(max_ext, ext)
        nc_dev = -(-int(max_ext * 1.05 + 128) // 128) * 128
        n_node_hops = H
        for h in range(H):
            if sat[h]:
                n_node_hops = h + 1
                break
        return n_node_hops, nc_dev

    # -- the draw -------------------------------------------------------------
    def sample(self, consts: SamplerConsts, key: int):
        """One CompactBatch + truncation-stat scalars, on the constants'
        device, from the generator seed ``key`` (``key_at``). Static shapes;
        no host synchronisation."""
        from bignn_tpu_torch.data.hierarchical import CompactBatch

        N, D, C = self.N, self.D, self.C
        dev = consts.adj_ptr.device
        i64 = torch.int64
        gen = self._generator(dev)
        gen.manual_seed(key)

        def arange(n):
            return torch.arange(n, dtype=i64, device=dev)

        def flag_first(x):  # x[i] != x[i-1], True at 0
            return torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                              x[1:] != x[:-1]])

        # 1. pairs ---------------------------------------------------------
        bs = self.batch_size
        pos = consts.train_pairs.long()[
            torch.randint(0, self.T, (bs,), generator=gen, device=dev)]
        negs = []
        for _ in range(self.neg_ratio):
            right = torch.rand(bs, generator=gen, device=dev) < 0.5
            rand = torch.randint(0, N, (bs,), generator=gen, device=dev)
            negs.append(torch.stack(
                [torch.where(right, pos[:, 0], rand),
                 torch.where(right, rand, pos[:, 1])], dim=1))
        all_pairs = torch.cat([pos] + negs)  # [pair_cap, 2]
        labels = torch.cat([
            torch.ones(bs, device=dev),
            torch.zeros(bs * self.neg_ratio, device=dev)])

        # 2-3. seeds + hop expansion ----------------------------------------
        xs = torch.sort(all_pairs.reshape(-1)).values
        m = (xs < N) & flag_first(xs)
        seeds = torch.sort(torch.where(m, xs, N)).values  # sentinel-N tail
        total = torch.clamp(m.sum(), max=D)
        node_segs = [seeds]
        es_bufs, frs = [], []
        hop_dropped = torch.zeros((), dtype=i64, device=dev)
        frontier = seeds[: self.fcaps[0]]
        adj_ptr = consts.adj_ptr.long()
        er = int(consts.adj_dst.shape[0])  # 16-wide aligned rows
        for h in range(self.active_hops):
            fanout = self.fanouts[h]  # <= 16, validated in __init__
            fc = self.fcaps[h]
            fr = frontier
            frc = torch.clamp(fr, max=N - 1)
            lo = adj_ptr[frc]
            deg = torch.where(fr < N, adj_ptr[frc + 1] - lo, 0)
            j = arange(fanout)
            # window draw: whole neighbourhood when deg <= fanout, else a
            # uniform-start window of the once-shuffled list (the JAX
            # package's estimator notes, device_sampler.py:464-476)
            u = torch.rand(fc, generator=gen, device=dev)
            start = torch.minimum(
                (u * (deg - fanout + 1).float()).long(), deg - fanout)
            start = torch.where(deg <= fanout, 0, start)
            pos0 = lo + start  # absolute start in the flat shuffled list
            rows = torch.stack([pos0 // 16, pos0 // 16 + 1], dim=1)
            flat = consts.adj_dst[rows.clamp(0, er - 1).reshape(-1)].reshape(
                fc, 32)  # two aligned rows cover any window of <= 16
            es = torch.gather(flat, 1, (pos0 % 16)[:, None] + j[None, :])
            es = torch.where(j[None, :] < deg[:, None], es.long(), N)
            es_bufs.append(es.reshape(-1))
            frs.append(fr)  # edge dst == frontier node (broadcast later)
            if h >= self.n_node_hops:
                continue  # edge-only hop: no dedup, no budget, no frontier
            # join-dedup: one sort over (kept nodes, candidates) on the key
            # id*2+flag; a kept node sorts first in its id group, so a
            # candidate is new iff it is its id's first entry with flag 1
            joint = torch.cat([torch.cat(node_segs) * 2,
                               es.reshape(-1) * 2 + 1])
            xs = torch.sort(joint).values
            ids = xs >> 1
            m_new = (xs < 2 * N) & ((xs & 1) == 1) & flag_first(ids)
            rank = torch.cumsum(m_new.long(), 0)
            ucount = rank[-1]
            keep = torch.minimum(ucount, D - total)
            nf = self.fcaps[h + 1]
            newf = torch.sort(torch.where(m_new & (rank <= keep), ids, N)
                              ).values[:nf]
            newf = torch.where(arange(nf) < keep, newf, N)
            hop_dropped = hop_dropped + (ucount - keep)
            node_segs.append(newf)
            total = total + keep
            frontier = newf

        # BFS-order node arrays (seeds first, then each node hop's kept
        # set), sentinel-padded; the budget holds by construction (seeds
        # fit, every hop was rank-truncated to D - total)
        nodes_b = torch.cat(node_segs)  # [M]
        bvalid = nodes_b < N
        nb_c = torch.clamp(nodes_b, max=N - 1)
        # edge-cap prefix truncation (BFS order, seeds first)
        eq = torch.where(bvalid, consts.qe.long()[nb_c], 0)
        ecv = bvalid & (torch.cumsum(eq, 0) <= self.EC)
        ecap_dropped = bvalid.sum() - ecv.sum()

        # 4. mixed-class packed layout --------------------------------------
        qn_b = torch.where(ecv, consts.qn.long()[nb_c], 0)
        n_sizes = consts.cls_of_size.shape[0]
        cls_b = torch.where(
            ecv, consts.cls_of_size.long()[torch.clamp(qn_b, max=n_sizes - 1)],
            C)
        # class-major [C, M]: the scan runs along the inner dimension (a
        # cumsum over the outer dimension of [M, C] took 3.6 ms of a step on
        # the H100)
        oh = (arange(C)[:, None] == cls_b[None, :]).long()
        ranks = torch.cumsum(oh, 1)  # [C, M]
        cnt = ranks[:, -1]  # per-class totals [C]
        cidx = torch.clamp(cls_b, max=C - 1)
        rank0 = torch.gather(ranks, 0, cidx[None, :])[0] - 1
        pb = consts.class_pb.long()
        sz = consts.class_size.long()
        fpb = consts.fpb.long()
        # descending class order: a class's filler demand comes only from
        # larger classes (static C-length loop over 0-d tensors)
        gx = self._gidx_np
        blocks_l, used_l, own_l = [None] * C, [None] * C, [None] * C
        for c in range(C - 1, -1, -1):
            demand = torch.zeros((), dtype=i64, device=dev)
            for c2 in range(c + 1, C):
                if gx[c2] == c:
                    demand = demand + blocks_l[c2] * int(self._fpb_np[c2])
            used_l[c] = torch.minimum(cnt[c], demand)
            own_l[c] = cnt[c] - used_l[c]
            blocks_l[c] = -(-own_l[c] // int(self._class_pb_np[c]))
        used = torch.stack(used_l)
        own = torch.stack(own_l)
        blocks = torch.stack(blocks_l)
        cap = blocks * fpb  # filler capacity hosted per class
        base = 128 * (torch.cumsum(blocks, 0) - blocks)
        # fillers of class g serve its client classes in ascending-base
        # order: exclusive cumsum of cap over each g's client set
        cap_w = torch.where(consts.client_mask, cap[None, :], 0)  # [C, C]
        capx_w = torch.cumsum(cap_w, 1) - cap_w
        fill_by = torch.minimum(
            torch.clamp(used[:, None] - capx_w, min=0), cap_w)
        fill = fill_by.sum(0)  # [C] fillers hosted in class c
        occ = own + fill
        slotbase = torch.cumsum(occ, 0) - occ
        # own molecules (rank >= used): standard placement
        ro = rank0 - used[cidx]
        pbc = pb[cidx]
        kb = ro // torch.clamp(pbc, min=1)
        mb = ro % torch.clamp(pbc, min=1)
        off_own = base[cidx] + kb * 128 + mb * sz[cidx]
        slot_own = (slotbase[cidx] + kb * pbc
                    + torch.minimum(fill[cidx], kb * fpb[cidx]) + mb)
        # filler molecules (rank < used): client class by capacity window
        capx_row = capx_w[cidx]  # [M, C]
        cap_row = cap_w[cidx]
        inc = ((rank0[:, None] >= capx_row)
               & (rank0[:, None] < capx_row + cap_row))
        cf = torch.argmax(inc.int(), 1)  # first client class
        qf = rank0 - torch.gather(capx_row, 1, cf[:, None])[:, 0]
        ff = torch.clamp(fpb[cf], min=1)
        kf = qf // ff
        mf = qf % ff
        off_f = base[cf] + kf * 128 + pb[cf] * sz[cf] + mf * sz[cidx]
        slot_f = (slotbase[cf] + torch.minimum(own[cf], (kf + 1) * pb[cf])
                  + kf * ff + mf)
        isfill = rank0 < used[cidx]
        off_b = torch.where(isfill, off_f, off_own)
        slot_b = torch.where(isfill, slot_f, slot_own)
        fits = ecv & (off_b + qn_b <= self.NC)
        ncap_dropped = ecv.sum() - fits.sum()
        n_real = fits.sum()
        slot_w = torch.where(fits, slot_b, D)  # D = the dropped row
        # one row write fills nodes and offsets together; row D is dropped
        out2 = torch.stack([torch.zeros(D + 1, dtype=i64, device=dev),
                            torch.full((D + 1,), self.NC, device=dev)], 1)
        out2[slot_w] = torch.stack([nodes_b, off_b], 1)
        nodes_out, off = out2[:D, 0], out2[:D, 1]

        # block_slot0[b] = #{slots : off // 128 < b}, closed-form per class
        # (own molecules + the fillers of its first blocks), capped at
        # n_real (node-cap drops are a slot suffix)
        bq = arange(self.NC // 128 + 1)[:, None]
        kbq = torch.minimum(torch.clamp(bq - (base // 128)[None, :], min=0),
                            blocks[None, :])
        per_cls = (torch.minimum(kbq * pb[None, :], own[None, :])
                   + torch.minimum(kbq * fpb[None, :], fill[None, :]))
        block_slot0 = torch.minimum(per_cls.sum(1), n_real)

        # local slot ids; invalid rows write the value D into row N
        local = torch.full((N + 1,), D, dtype=i64, device=dev)
        local[torch.where(fits, nodes_b, N)] = slot_w

        # 5. outer subgraph -------------------------------------------------
        es = torch.cat(es_bufs)
        la = local[torch.clamp(es, max=N)]
        # hop h's frontier is the fcaps[h]-prefix of node segment
        # min(h, last), and slot_w is ordered like concat(node_segs), so the
        # frontier's slots are a slice of slot_w
        seg_off = np.cumsum([0] + [int(s.shape[0]) for s in node_segs])
        lb = torch.cat([
            slot_w[int(seg_off[min(h, len(node_segs) - 1)]):][: fr.shape[0]]
            [:, None].expand(fr.shape[0], self.fanouts[h]).reshape(-1)
            for h, fr in enumerate(frs)])
        ok = (la < D) & (lb < D) & (la != lb)
        # canonical-pair dedup on the int64 key lo * (D + 1) + hi; the
        # sentinel pair (D, 0) sorts after every valid pair
        w = D + 1
        key = torch.where(ok, torch.minimum(la, lb) * w + torch.maximum(la, lb),
                          D * w)
        ks = torch.sort(key).values
        m_u = ((ks // w) < D) & flag_first(ks)
        ucnt = m_u.sum()
        kc = torch.sort(torch.where(m_u, ks, D * w)).values
        U = self.U
        kept = torch.clamp(ucnt, max=U)
        outer_dropped = (ucnt - kept) * 2  # both directions drop
        uval = arange(U) < kept
        klo, khi = kc[:U] // w, kc[:U] % w
        # (dst, src) order: canonical pair (lo, hi) emits (src=hi, dst=lo)
        # and (src=lo, dst=hi), live self-loops (d, d); the three families
        # are disjoint, so the stable sort gives the dst-sorted list with
        # each dst block src-sorted, sentinels (D, 0) in origin order
        slot = arange(D)
        lv = slot < n_real
        dst_all = torch.cat([torch.where(uval, klo, D),
                             torch.where(uval, khi, D),
                             torch.where(lv, slot, D)])  # [L = 2U + D]
        src_all = torch.cat([torch.where(uval, khi, 0),
                             torch.where(uval, klo, 0),
                             torch.where(lv, slot, 0)])
        L = int(dst_all.shape[0])
        o3 = torch.sort(dst_all * w + src_all, stable=True).indices
        sv_s, su_s = dst_all[o3], src_all[o3]
        vale = sv_s < D
        # free src-sort perm: the list is symmetric, so the k-th src-sorted
        # edge is the mirror of the k-th dst-sorted one; canonical pair c's
        # entries at origins c and U + c point at each other, loops and
        # padding are fixed points
        is_a = vale & (o3 < U)
        is_b = vale & (o3 >= U) & (o3 < 2 * U)
        inv = torch.empty(L, dtype=i64, device=dev)
        inv[o3] = arange(L)
        operm = inv[torch.where(is_a, o3 + U, torch.where(is_b, o3 - U, o3))]
        pad = self.OE - L  # init asserts 2U + D <= OE
        outer_src = torch.cat([su_s, torch.zeros(pad, dtype=i64, device=dev)]
                              ).to(self.idt)
        outer_dst = torch.cat([sv_s, torch.full((pad,), D, device=dev)]
                              ).to(self.idt)
        outer_perm = torch.cat([operm, torch.arange(L, self.OE, device=dev)]
                               ).to(torch.int32)

        # pairs -> local slots; endpoints dropped by any truncation mask out
        pa = local[all_pairs[:, 0]]
        pb2 = local[all_pairs[:, 1]]
        pv = (pa < D) & (pb2 < D)
        pairs_local = torch.stack(
            [torch.where(pv, pa, 0), torch.where(pv, pb2, 0)], 1).to(self.idt)

        i32 = torch.int32
        dropped = hop_dropped + ecap_dropped + ncap_dropped
        stats = {
            "trunc_nodes_dropped": dropped.to(i32),
            # the device-calibrated node cap's own drops, surfaced so a
            # persistent estimator bias warns (MinibatchTrainer)
            "trunc_ncap_dropped": ncap_dropped.to(i32),
            "trunc_outer_edges_dropped": outer_dropped.to(i32),
            "trunc_batches": ((dropped + outer_dropped) > 0).to(i32),
            "batches_sampled": torch.ones((), dtype=i32, device=dev),
        }
        cb = CompactBatch(
            nodes=nodes_out.to(i32),
            n_real=n_real.to(i32),
            pack_off=off.to(i32),
            block_slot0=block_slot0.to(i32),
            outer_src=outer_src,
            outer_dst=outer_dst,
            outer_weight=None,  # GCN weights still derived on device
            # mirror identity: src-sorted src values == dst-sorted dst
            # values (outer_dst doubles as outer_src_sorted)
            outer_src_perm=outer_perm,
            outer_src_sorted=outer_dst,
            pairs=pairs_local,
            labels=labels,
            mask=pv.float(),
            drug_budget=D,
            node_cap=self.NC,
            edge_cap=self.EC,
            outer_edge_cap=self.OE,
        )
        return cb, stats


def _mix(*words: int) -> int:
    """A 63-bit generator seed from integers (NumPy's SeedSequence)."""
    state = np.random.SeedSequence([w & 0xFFFFFFFF for w in words]
                                   ).generate_state(2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])
