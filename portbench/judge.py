"""What decides ``correct``: the engine's commits, and the served
tokens against the plain float32 reference.

Commits: every request of every loop committed exactly once, with the
tokens of its first completion (the earliest of the chunk runs that
returned it), and no loop hung.

Tokens: a sample of the finished requests, drawn from the seed, with
the one that served the most tokens and the one with the longest prompt
in it, until it holds the mix's ``check_tokens`` served tokens.  The
reference runs once over each prompt followed by its served tokens;
at each served position the gap is the reference's best logit minus
the logit of the token the program served.  ``max_gap``, the widest,
is held to the cell's limit.  The precision control (``control_gaps``)
reads the gap of the token that the reference put first when computed
one precision below the served one."""

from __future__ import annotations

import numpy as np
import torch

from portbench import traffic


def commit_faults(loops: list) -> dict:
    """Counts over every loop: requests never committed, committed other
    than once, committed with other tokens than their first completion;
    loops that hung."""
    never = not_once = not_first = hung = 0
    for lp in loops:
        hung += int(lp["hung"])
        for r in lp["requests"]:
            if r.output is None:
                never += 1
                continue
            if r.__dict__.get("commits", 0) != 1:
                not_once += 1
            done = sorted(lp["completions"].get(r.rid, []),
                          key=lambda c: c[0])
            if not done or not np.array_equal(done[0][1], r.output):
                not_first += 1
    return dict(uncommitted=never, commits_not_once=not_once,
                not_first_completion=not_first, hung_loops=hung)


def sample(requests: list, check_tokens: int, seed: int) -> list:
    """Finished requests to hold to the reference (see the module)."""
    done = [r for r in requests if r.output is not None]
    if not done:
        return []
    picks = [max(range(len(done)), key=lambda i: len(done[i].output)),
             max(range(len(done)), key=lambda i: len(done[i].prompt))]
    order = traffic.rng(seed, traffic.SAMPLE_STREAM).permutation(len(done))
    chosen: list = []
    for i in [*picks, *order.tolist()]:
        if i in chosen:
            continue
        if sum(len(done[j].output) for j in chosen) >= check_tokens:
            break
        chosen.append(i)
    return [done[i] for i in chosen]


def _seqs(reqs: list):
    seqs = [np.concatenate([r.prompt, r.output[:-1]]).astype(np.int64)
            for r in reqs]
    pos = [np.arange(len(r.prompt) - 1, len(r.prompt) + len(r.output) - 1)
           for r in reqs]
    return seqs, pos


def reference_logits(ref, weights, model, reqs, device,
                     precision="float32") -> list:
    seqs, pos = _seqs(reqs)
    return ref.logits(weights, model, seqs, pos, precision=precision,
                      device=device)


def gaps(logits: list, tokens: list) -> np.ndarray:
    """Per position: best logit minus the logit of ``tokens``."""
    out = []
    for lg, tok in zip(logits, tokens):
        t = torch.as_tensor(np.asarray(tok, dtype=np.int64),
                            device=lg.device)
        out.append((lg.max(-1).values - lg.gather(-1, t[:, None])[:, 0])
                   .double().cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def served_gaps(ref, weights, model, reqs, device) -> tuple:
    """(gaps of the served tokens, the float32 logits)."""
    lg = reference_logits(ref, weights, model, reqs, device)
    return gaps(lg, [r.output for r in reqs]), lg


def control_gaps(ref, weights, model, reqs, device, precision,
                 exact_logits: list) -> np.ndarray:
    """Gaps, under the float32 logits, of the tokens the reference puts
    first at ``precision``, at the same positions."""
    low = reference_logits(ref, weights, model, reqs, device, precision)
    firsts = [lg.argmax(-1).cpu().numpy() for lg in low]
    return gaps(exact_logits, firsts)
