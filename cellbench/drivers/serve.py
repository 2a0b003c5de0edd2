"""Serving cells: the port's ``Server`` in a closed loop of ``clients``
clients, each sending its next request when its last one completes.

The ``Server`` batches ``clients`` requests a ``step_epoch``: it pads
them on the right with token 0 to the longest prompt, prefills them
together and decodes the batch until its longest output is done. Set-up
makes the weights and serves one warm-up epoch at the mix's longest
prompt and output. A request's latency runs from its submission to the
host seeing its completion; the window ends with the first epoch that
completes after ``--seconds``.

After the window a sample of the epochs, drawn from the seed with the
longest request's among them, is served again by the reference, row for
row as the ``Server`` batched it, and each served token's logit is read
against the reference's best (:func:`reference.decoder.serve_follow`).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from cellbench import judge
from cellbench.drivers import Ctx, Outcome, Window, free, peak, per_token
from cellbench.generate import longest, requests, warmup_requests
from cellbench.reference import decoder as ref_decoder
from cellbench.reference import family
from cellbench.weights import make_weights


def run(ctx: Ctx) -> Outcome:
    from repro_torch.runtime import serve_loop as SL
    mix, cfg = ctx.cell.traffic, ctx.cfg
    clients, V = int(mix["clients"]), cfg.vocab_size
    s_max = longest(mix["prompt_tokens"]) + longest(mix["output_tokens"])
    w = make_weights(cfg, ctx.seed, ctx.device)
    ctx.phase("weights")
    srv = SL.Server(cfg, ctx.run, batch=clients, s_max=s_max,
                    device=ctx.device, params=w)
    ctx.phase("program")
    for i, (p, o) in enumerate(warmup_requests(mix, ctx.seed, V, clients)):
        srv.submit(SL.Request(rid=-1 - i, prompt=torch.from_numpy(p),
                              max_new_tokens=o))
    srv.step_epoch()
    srv.completions.clear()

    stream = requests(mix, ctx.seed, V)
    reqs = {}                      # rid -> (prompt, max_new, submitted)
    served, done_at, epochs = {}, {}, []

    def submit(t: float) -> None:
        p, o = next(stream)
        rid = len(reqs)
        reqs[rid] = (p, o, t)
        srv.submit(SL.Request(rid=rid, prompt=torch.from_numpy(p),
                              max_new_tokens=o, submitted_t=t))

    with Window(ctx) as win:
        for _ in range(clients):
            submit(win.t0)
        while True:
            epochs.append([r.rid for r in srv.queue[:clients]])
            done = srv.step_epoch()
            t = time.perf_counter()
            for c in done:
                served[c.rid], done_at[c.rid] = c.tokens, t
            if t - win.t0 >= ctx.seconds:
                break
            for _ in done:
                submit(t)
    ctx.memory_peak = peak(ctx)
    del srv
    free(ctx)

    bad = sum(len(served.get(r, ())) != o
              or not all(0 <= t < V for t in served.get(r, ()))
              for r, (_, o, _) in reqs.items())
    tokens = sum(len(s) for s in served.values())
    lat = [done_at[r] - reqs[r][2] for r in served]
    m = ctx.cell.model_fields()
    gaps = []
    for e in sample(epochs, reqs, served, ctx.seed,
                    int(ctx.cell.limits["sample_tokens"])):
        prompts, rows = batch_of(epochs[e], reqs, served, clients, ctx.device)
        gaps += ref_decoder.serve_follow(w, m, family(m["family"]).kinds(m),
                                         prompts, rows)["gaps"]
    return Outcome(
        metrics={"serve_tokens_per_s": tokens / ctx.window_s,
                 "request_latency_p95_s": float(np.percentile(lat, 95)),
                 "energy_mj_per_token": per_token(ctx.energy_j, tokens)},
        counts={"tokens": tokens, "requests": len(served),
                "prompt_tokens": sum(len(reqs[r][0]) for r in served),
                "epochs": len(epochs), "energy_j": ctx.energy_j},
        numbers=judge.serve_numbers(gaps),
        attempted=len(reqs), failed=int(bad),
        extra={"epochs": epochs, "reqs": reqs, "served": served,
               "weights": w, "gaps": gaps})


def sample(epochs, reqs, served, seed: int, want_tokens: int):
    """Epoch indices to check: the one holding the longest request
    (prompt and output), then others in an order drawn from the seed, until
    their served tokens reach ``want_tokens``."""
    def size(r):
        return len(reqs[r][0]) + reqs[r][1]
    top = max((r for e in epochs for r in e), key=size)
    first = next(i for i, e in enumerate(epochs) if top in e)
    rest = [i for i in np.random.default_rng([seed, 7]).permutation(
        len(epochs)) if i != first]
    out, got = [], 0
    for i in [first] + rest:
        out.append(int(i))
        got += sum(len(served.get(r, ())) for r in epochs[i])
        if got >= want_tokens:
            break
    return out


def batch_of(rids, reqs, served, clients: int, device):
    """The padded prompts [clients, S] of one epoch as the ``Server``
    built them (rows past the requests are all token 0) and each row's
    served tokens."""
    S = max(len(reqs[r][0]) for r in rids)
    prompts = np.zeros((clients, S), dtype=np.int64)
    rows = [[] for _ in range(clients)]
    for j, r in enumerate(rids):
        p = reqs[r][0]
        prompts[j, :len(p)] = p
        rows[j] = list(served.get(r, []))
    return torch.from_numpy(prompts).to(device), rows
