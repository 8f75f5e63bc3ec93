"""Closed-loop MIPS serving: callers that each send their next query when
their last answer returns, through the port's `MIPSServeEngine`
(``submit`` / ``poll`` / ``result``) over a seeded item table.

Set-up makes the table on the card from the seed, builds the engine (its
executor re-lays the table tile-major and calibrates the plan), draws
``pool_queries_per_s`` queries for each second of the window, and serves
warm-up batches.  The window runs ``--seconds``; callers that get past
the drawn queries draw more a chunk at a time (the rate is never capped),
and a request counts from the moment its caller issues it to the moment
its answer is in the caller's hands.  A traced run then goes on under
``torch.profiler`` for ``trace_seconds``.

``correct`` compares a seeded sample of the answered requests with the
plain reference's exact top-K (`reference.exact_topk`), by the numbers
the cell's limits file names (see `compare`).
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from portbench import devtrace, reference, weights

#: seconds past the window a request may still be answered in; one that
#: is not counts as failed, its latency the window plus this
GIVE_UP = 60.0


class QueryStream:
    """Queries (float32, host) made a chunk at a time as they are asked
    for: each a row drawn by a Zipf law of exponent ``zipf_s`` over the
    row ids (id ``i`` has rank ``i + 1``), scaled to unit norm, plus
    Gaussian noise of about unit norm; chunk ``j`` is drawn on
    ``table``'s device from ``(seed, path, j)`` alone, so the same seed
    gives the same queries however many the callers take."""

    def __init__(self, table: torch.Tensor, seed: int, zipf_s: float,
                 path: int, chunk: int):
        self.table, self.seed, self.path, self.chunk = (table, seed, path,
                                                        chunk)
        ranks = torch.arange(1, table.shape[0] + 1, dtype=torch.float64,
                             device=table.device)
        cdf = torch.cumsum(ranks ** -zipf_s, 0)
        self.cdf = cdf / cdf[-1].clone()
        self.chunks = []

    def __len__(self) -> int:
        return len(self.chunks) * self.chunk

    def fill(self, n: int) -> None:
        """Draw chunks until ``n`` queries are drawn."""
        while len(self) < n:
            self.draw()

    def draw(self) -> None:
        """Append the next chunk."""
        rows, d = self.table.shape
        dev = self.table.device
        g = weights.generator(self.seed, dev, self.path, len(self.chunks))
        u = torch.rand(self.chunk, generator=g, device=dev,
                       dtype=torch.float64)
        ids = torch.searchsorted(self.cdf, u).clamp_max(rows - 1)
        v = self.table[ids].to(torch.float32)
        v /= v.norm(dim=1, keepdim=True)
        v += torch.randn((self.chunk, d), generator=g, device=dev) \
            / math.sqrt(d)
        self.chunks.append(v.cpu().numpy())

    def __getitem__(self, i: int) -> np.ndarray:
        self.fill(i + 1)
        return self.chunks[i // self.chunk][i % self.chunk]

    def take(self, idx: np.ndarray) -> np.ndarray:
        """The queries at indices ``idx`` (all drawn already)."""
        return np.stack([self[int(i)] for i in idx])


class ClosedLoop:
    """``callers`` closed-loop clients over one engine, queries taken in
    order from a `QueryStream`; times every engine call.  Each request's
    issue and answer times and its answer land in arrays indexed by its
    query, grown a chunk at a time."""

    def __init__(self, engine, queries: QueryStream, callers: int,
                 limit: Optional[int] = None):
        self.eng, self.queries, self.callers = engine, queries, callers
        self.limit = limit
        self.next_q = 0
        self.t_issue = np.zeros(0)
        self.t_done = np.zeros(0)
        self.ids = np.zeros((0, engine.K), np.int64)
        self.scores = np.zeros((0, engine.K), np.float32)
        self.inflight: Dict[int, int] = {}  # request id -> query index
        self.engine_s = 0.0

    def _grow(self) -> None:
        n = self.queries.chunk
        self.t_issue = np.concatenate([self.t_issue, np.full(n, np.nan)])
        self.t_done = np.concatenate([self.t_done, np.full(n, np.nan)])
        K = self.ids.shape[1]
        self.ids = np.concatenate([self.ids, np.zeros((n, K), np.int64)])
        self.scores = np.concatenate([self.scores,
                                      np.zeros((n, K), np.float32)])

    def issue(self) -> bool:
        if self.limit is not None and self.next_q >= self.limit:
            return False
        i = self.next_q
        if i >= len(self.t_issue):
            self._grow()
        q = self.queries[i]
        self.next_q += 1
        t = time.perf_counter()
        rid = self.eng.submit(q)
        self.engine_s += time.perf_counter() - t
        self.t_issue[i] = t
        self.inflight[rid] = i
        return True

    def run(self, until: float, issuing: bool = True) -> None:
        """Serve until ``until`` (``perf_counter``), each answer followed
        by its caller's next query while ``issuing`` and before
        ``until``; then, with ``issuing`` false, until nothing is in
        flight (at most `GIVE_UP` seconds past ``until``)."""
        while len(self.inflight) < self.callers and issuing:
            if not self.issue():
                break
        while self.inflight:
            t = time.perf_counter()
            if t > until + GIVE_UP:
                return
            done, _ = self.eng.poll()
            self.engine_s += time.perf_counter() - t
            for rid in done:
                t = time.perf_counter()
                ids, scores = self.eng.result(rid)
                t_got = time.perf_counter()
                self.engine_s += t_got - t
                i = self.inflight.pop(rid)
                self.t_done[i] = t_got
                self.ids[i], self.scores[i] = ids, scores
                if issuing and t_got < until:
                    self.issue()
            if not issuing and not self.inflight:
                return
            if issuing and time.perf_counter() >= until:
                return


def compare(Q: torch.Tensor, table: torch.Tensor, K: int,
            ids: torch.Tensor, scores: torch.Tensor,
            ref: Optional[tuple] = None) -> Dict[str, float]:
    """The numbers of served ``ids (n, K)`` and their ``scores (n, K)``
    (``q . v / d``, as the engine serves them) against the reference on
    queries ``Q (n, d)``; ``ref``: the reference's ``exact_topk`` if
    already computed.  An answer with an id out of range or repeated
    reads infinite in each; the first two are relative to the
    reference's best q.v:

    * ``score_err``: the widest gap between a served score and the
      reference's q.v of the id it was served for;
    * ``top1_err``: the widest gap between the served best score and the
      reference's best;
    * ``rank_shortfall``: the widest shortfall, over the answers, of the
      sum of the q.v of the served ranks 2..K (the reference's q.v of
      the served ids, in descending order) below the sum of the
      reference's ranks 2..K, relative to that sum;
    * ``recall``: the served ids' share of the reference's top-K (not
      compared).
    """
    rows, d = table.shape
    ref_ids, ref_s = ref if ref is not None else reference.exact_topk(
        Q, table, K)
    best = ref_s[:, 0].abs()
    ok = ((ids >= 0) & (ids < rows)).all(dim=1)
    srt = torch.sort(ids, dim=1).values
    ok &= (srt[:, 1:] != srt[:, :-1]).all(dim=1)
    inf = torch.full_like(best, math.inf)
    mine = reference.scores_of(Q, table, ids.clamp(0, rows - 1))
    err = (scores.to(torch.float64) * d - mine).abs().amax(dim=1) / best
    top1 = (scores[:, 0].to(torch.float64) * d - ref_s[:, 0]).abs() / best
    tail = ref_s[:, 1:].sum(dim=1)
    got = torch.sort(mine, dim=1, descending=True).values[:, 1:].sum(dim=1)
    short = (tail - got) / tail.abs()
    hits = (ids[:, :, None] == ref_ids[:, None, :]).any(dim=2)
    return {"score_err": float(torch.where(ok, err, inf).max()),
            "top1_err": float(torch.where(ok, top1, inf).max()),
            "rank_shortfall": float(torch.where(ok, short, inf).max()),
            "recall": float(hits.to(torch.float32).mean())}


def planted_fault(Q: torch.Tensor, table: torch.Tensor, ref: tuple,
                  seed: int) -> tuple:
    """The answer of a cascade that finds the best row and nothing else:
    the reference's best id, then ``K - 1`` ids drawn at random from the
    seed (distinct, none the best), each scored exactly."""
    ref_ids = ref[0]
    n, K = ref_ids.shape
    rows = table.shape[0]
    g = weights.generator(seed, "cpu", 10)
    rnd = torch.randint(0, rows - 1, (n, K - 1), generator=g).to(
        ref_ids.device)
    rnd = rnd + (rnd >= ref_ids[:, :1]).long()
    ids = torch.cat([ref_ids[:, :1], rnd], dim=1)
    srt = torch.sort(ids, dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]).any(dim=1)
    ids[dup, 1:] = (ids[dup, :1] + torch.arange(1, K, device=ids.device)
                    * 7919) % rows
    scores = reference.scores_of(Q, table, ids) / table.shape[1]
    return ids, scores.to(torch.float32)


def run(run, control: bool = False) -> dict:
    marks = [("start", time.perf_counter())]
    from repro_torch.launch.engine import MIPSServeEngine
    marks.append(("import", time.perf_counter()))
    cfg, tr = run.cell.config, run.cell.traffic
    eng_kw = cfg["engine"]
    dev = torch.device(run.device)
    dtype = getattr(torch, cfg["dtype"])
    table = weights.seeded_table(cfg["vocab_size"], cfg["hidden_size"],
                                 cfg["initializer_range"], dtype, run.seed,
                                 dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    marks.append(("table", time.perf_counter()))
    engine = MIPSServeEngine(
        table, **eng_kw, batch_size=tr["batch_size"],
        deadline_ms=tr["deadline_ms"], seed=weights.derive(run.seed, 5),
        device=dev)
    marks.append(("engine", time.perf_counter()))
    lanes, callers = tr["batch_size"], tr["callers"]
    queries = QueryStream(table, run.seed, tr["zipf_s"], 6,
                          tr["query_chunk"])
    span = run.seconds + (tr["trace_seconds"] if run.trace else 0.0)
    queries.fill(int(math.ceil(tr["pool_queries_per_s"] * span)) + callers)
    marks.append(("queries", time.perf_counter()))
    warm = ClosedLoop(engine, QueryStream(table, run.seed, tr["zipf_s"], 7,
                                          tr["query_chunk"]),
                      lanes, limit=tr["warmup_batches"] * lanes)
    warm.run(time.perf_counter() + 3600.0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    marks.append(("warmup", time.perf_counter()))
    hist = engine.metrics.get("cascade_dispatch_ms")
    h0 = (hist.sum(), hist.count())

    loop = ClosedLoop(engine, queries, callers)
    # the set-up's objects leave the collector's view, so its passes in
    # the window scan what the window makes
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    t_end = t0 + run.seconds
    loop.run(t_end)
    window_engine_s = loop.engine_s
    h1 = (hist.sum(), hist.count())
    summary = None
    if run.trace:
        with devtrace.traced() as prof:
            with devtrace.window():
                loop.run(time.perf_counter() + tr["trace_seconds"])
                loop.run(time.perf_counter(), issuing=False)
                torch.cuda.synchronize(dev)
        summary = devtrace.summarize(prof)
    loop.run(time.perf_counter(), issuing=False)
    gc.unfreeze()
    n = loop.next_q
    t_issue, t_done = loop.t_issue[:n], loop.t_done[:n]
    issued = t_issue < t_end
    done = ~np.isnan(t_done)
    lat = np.where(done, t_done - t_issue, run.seconds + GIVE_UP)
    lat_ms = lat[issued] * 1e3
    failed = int((~done).sum())
    answered = int((issued & (t_done <= t_end)).sum())
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    plan = engine.plan
    served = np.flatnonzero(done)
    del engine, warm
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    rng = np.random.default_rng(weights.derive(run.seed, 8))
    n_check = min(tr["check_requests"], len(served))
    pick = np.sort(rng.choice(served, n_check, replace=False))
    Q = torch.from_numpy(queries.take(pick)).to(dev)
    ids = torch.from_numpy(loop.ids[pick]).to(dev)
    scores = torch.from_numpy(loop.scores[pick]).to(dev)
    K = eng_kw["K"]
    ref = reference.exact_topk(Q, table, K)
    got = compare(Q, table, K, ids, scores, ref)
    t_ref = time.perf_counter() - t_ref
    limits = run.cell.limits
    out = {
        "metrics": {"serve_p95_ms": float(np.percentile(lat_ms, 95)),
                    "serve_qps": answered / run.seconds},
        "attempted": int(issued.sum()), "failed": failed,
        "checks": {k: {"value": got[k], "limit": limits[k]["limit"]}
                   for k in limits},
        "memory_peak_bytes": peak, "window_start": t0, "trace": summary,
        "info": {"recall": got["recall"], "checked": n_check,
                 "p50_ms": float(np.percentile(lat_ms, 50)),
                 "queries_drawn": len(queries), "queries_used": n,
                 "reference_s": t_ref,
                 "setup": {b[0]: round(b[1] - a[1], 3)
                           for a, b in zip(marks, marks[1:])}},
        "reading": {
            "kind": "serve", "trace": summary, "plan": plan,
            "lanes": lanes, "table_itemsize": table.element_size(),
            "answered": answered, "engine_s": window_engine_s,
            "dispatch_ms_sum": h1[0] - h0[0],
            "dispatches": h1[1] - h0[1]},
    }
    if run.trace:
        out["card"] = devtrace.card()
    if control:
        c_ids, c_s = reference.exact_topk(Q, table, K, tf32=True)
        out["control"] = compare(Q, table, K, c_ids,
                                 c_s / table.shape[1], ref)
        f_ids, f_s = planted_fault(Q, table, ref, run.seed)
        out["fault"] = compare(Q, table, K, f_ids, f_s, ref)
    return out
