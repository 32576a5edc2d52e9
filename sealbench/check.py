"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample of
the requests it finished, drawn from the seed with the longest of them in
it, runs through the plain f32 reference once each: its prompt followed by
its served tokens. At every served token the reference's logits say how
far that token lies below the reference's best (0 where they pick the
same). The widest of those gaps over the sample is held to the cell's
limit. The control reads, at the same positions of the same prompts and
tokens, the gap of the token that a float8 copy of the reference puts
first.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def sample(records, seed: int, want_tokens: int, max_requests: int) -> List:
    """Finished requests without error: the one with the longest context
    first, then others in an order drawn from the seed, until the served
    tokens reach ``want_tokens`` or the count ``max_requests``."""
    done = sorted((r for r in records
                   if r.t_done is not None and r.error is None),
                  key=lambda r: r.req.rid)
    if not done:
        return []
    rng = np.random.default_rng([seed % 2 ** 63, 2])
    longest = max(done, key=lambda r: (len(r.prompt) + len(r.req.out),
                                       -r.req.rid))
    rest = [r for r in done if r is not longest]
    picked, served = [longest], len(longest.req.out)
    for i in rng.permutation(len(rest)):
        if served >= want_tokens or len(picked) >= max_requests:
            break
        picked.append(rest[int(i)])
        served += len(rest[int(i)].req.out)
    return picked


def gaps(ref, c: dict, w, recs, device, control: bool = False) -> Dict:
    """The widest gap by which a served token's logit lies below the
    reference's best, over ``recs``; with ``control`` also the widest gap
    of the tokens the float8 control puts first. A token outside the
    vocabulary reads an infinite gap."""
    import torch

    vocab = c["vocab_size"]
    widest, widest_ctrl, tokens = 0.0, 0.0, 0
    for r in recs:
        out = list(r.req.out)
        if not out:
            continue
        tokens += len(out)
        if min(out) < 0 or max(out) >= vocab:
            widest = float("inf")
            continue
        p = len(r.prompt)
        seq = np.concatenate([np.asarray(r.prompt, np.int64),
                              np.asarray(out[:-1], np.int64)])
        toks = torch.as_tensor(seq, device=device)
        at = torch.arange(p - 1, p - 1 + len(out), device=device)
        with torch.no_grad():
            logits = ref.forward(c, w, toks, at)
            best = logits.max(dim=-1).values
            served = torch.as_tensor(out, device=device)[:, None]
            g = (best - logits.gather(1, served)[:, 0]).max()
            widest = max(widest, float(g))
            if control:
                low = ref.forward(c, w, toks, at, matmul=ref.fp8_matmul)
                pick = low.argmax(dim=-1)[:, None]
                cg = (best - logits.gather(1, pick)[:, 0]).max()
                widest_ctrl = max(widest_ctrl, float(cg))
    out: Dict[str, Optional[float]] = {"widest_gap": widest,
                                       "tokens": tokens,
                                       "requests": len(recs)}
    if control:
        out["control_gap"] = widest_ctrl
    return out
