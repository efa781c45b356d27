"""The comparison that decides `correct`: the program's decode outputs
against the plain reference (perfbench/reference), and the control.

A beam decode's outputs are choices, so the reference follows them. For
each sampled utterance it starts from its architecture's first state
(perfbench/arch.py), runs its own model math along the ancestry that the
program's parent pointers and predictions give, step by step, and at
every step judges the program's selection among the candidates that the
reference itself works out:

  sel_gap     v2, nats: the most by which a candidate that the program
              left out scores above one it kept, by the reference's
              scores (for the last slot, the best on-diagonal candidate
              against the one kept there);
  sel_rel     v1: the same over the kept candidate's log-prob (_scale);
  invalid     selected candidates that the rules prune;
  lp_err      v2, nats: the most by which a final cumulative log-prob
              differs from the reference's along the same ancestry;
  lp_rel      v1: the same over the reference's log-prob (_scale);
  mel_err     v1: the most by which a value of the program's mel
              differs from the reference's (its architecture's
              v1_output of the best path's frames), over the reference's
              RMS;
  mismatches  integer outputs that differ from what the reference derives
              from the same choices: v1 the source position of each slot,
              the predictions, the frame count and the best path's
              alignment; v2 the predictions, totals, finished flags,
              emptied flags, the ordered ancestry, the durations, the
              output lengths and the frame-to-source indexes.

A cell's workload file names the numbers compared and their limits.

The control is the reference in the program's place, computed one
precision below the configuration's (float8 e4m3 for bfloat16): along the
same ancestry it selects by its own scores and carries its own log-probs
and frames, and its log-prob numbers and mel_err are read as the program's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench.reference import beam
from perfbench.reference.numerics import Num

V1_FIELDS = ("pred", "nt", "nu", "fin")
V2_FIELDS = ("pred", "nt", "nu", "fin", "tot")
LOWER = {"bfloat16": torch.float8_e4m3fn}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _stack(rows: List[dict], key: str, device) -> torch.Tensor:
    return torch.as_tensor(np.stack([r[key] for r in rows]), device=device)


def _scale(lp):
    """What a v1 log-prob's error is measured against: its size, at least
    0.1 nat. Each shift adds a log-prob of a few nats whose bf16 rounding
    moves it by up to ~0.06 nats, so the error a sound run carries grows
    with the shifts in a path, and so with the log-prob's size; a path of
    emits alone keeps its log-prob near 0, where the floor holds."""
    return lp.abs().clamp(min=0.1)


def _first(label):
    """(R, W) -> True where no earlier slot of the row holds the label."""
    W = label.shape[1]
    same = label[:, :, None] == label[:, None, :]
    earlier = torch.tril(torch.ones(W, W, dtype=torch.bool,
                                    device=label.device), -1)
    return ~(same & earlier).any(2)


def _take(x, par, k):
    """x (R, W, K) -> (R, Wout) at each output slot's (parent, class)."""
    K = x.shape[2]
    flat = x.reshape(x.shape[0], -1)
    return flat.gather(1, par * K + k)


def _selected(label, par, k, K):
    """(R, W, K) mask of the candidates (by parent label and class) that
    the output slots hold."""
    plab = label.gather(1, par)                               # (R, Wo)
    hit = ((label[:, :, None] == plab[:, None, :])[..., None]
           & (k[:, None, :, None] == torch.arange(K, device=k.device)))
    return hit.any(2)


def _twins(c, sel, pool, keys, tol):
    """(R, W, K) the candidates that share every integer field (`keys`)
    with a selected one, and whose reference log-prob lies within
    `tol(log-prob)` of it. A selection drops a candidate that equals its
    predecessor in the sorted order on every field, the log-prob too;
    different hypotheses can reach bit-equal log-probs, and the program's
    log-probs may lie as far as the cell's log-prob limit from the
    reference's, so such a pair may have been equal there."""
    R = sel.shape[0]
    f = lambda x: x.reshape(R, -1)
    lp = f(c["lp"])
    same = (lp[:, :, None] - lp[:, None, :]).abs() <= tol(lp)[:, :, None]
    for key in keys:
        same &= f(c[key])[:, :, None] == f(c[key])[:, None, :]
    return (same & f(sel & pool)[:, None, :]).any(2).reshape(sel.shape)


def _inversion(score, sel, pool, excused=None, scale=None):
    """(R,) the most by which an unselected candidate of `pool` (less the
    `excused`) scores above a selected one (0 where none does); with
    `scale`, over scale(the lower score)."""
    inf = torch.tensor(float("inf"), device=score.device)
    lo = torch.where(sel & pool, score, inf).flatten(1).amin(1)
    left = pool & ~sel if excused is None else pool & ~sel & ~excused
    hi = torch.where(left, score, -inf).flatten(1).amax(1)
    gap = hi - lo
    if scale is not None:
        gap = gap / scale(torch.where(torch.isfinite(lo), lo, 0.0))
    return torch.where(torch.isfinite(gap), gap.clamp(min=0.0),
                       torch.zeros_like(gap))


def _top(score, pool, m):
    """(R, W, K) mask of the m best candidates of `pool` by score."""
    R = score.shape[0]
    flat = torch.where(pool, score, -torch.inf).reshape(R, -1)
    rank = flat.argsort(1, descending=True).argsort(1)
    return (rank < m[:, None]).reshape(score.shape) & pool


def _relabel(label, par, k, K):
    """The identity of each output slot: (parent's identity, class),
    numbered afresh."""
    key = label.gather(1, par) * K + k
    return torch.unique(key, return_inverse=True)[1].reshape(key.shape)


class Judge:
    """Holds the reference (`ref`, an architecture's reference module) and
    the control over the sampled rows."""

    def __init__(self, ref, params: Dict[str, torch.Tensor], cfg: dict,
                 device, control: bool, limits: Dict[str, float]):
        self.ref = ref
        self.P = {k: v.to(device=device, dtype=torch.float32)
                  for k, v in params.items()}
        self.cfg = cfg
        self.device = device
        self.limits = limits
        self.nums = {"ref": Num(DTYPES[cfg["dtype"]])}
        if control:
            self.nums["ctl"] = Num(LOWER[cfg["dtype"]])

    def encode(self, toks, il):
        return {k: self.ref.encode(self.P, self.cfg, toks, il, n)
                for k, n in self.nums.items()}

    def v1(self, rows: List[dict], W: int) -> Dict[str, dict]:
        dev = self.device
        toks = _stack(rows, "tokens", dev).long()
        il = _stack(rows, "input_length", dev).long()
        branches = _stack(rows, "beam_branch", dev).long()     # (R, U, W)
        t_hist = _stack(rows, "t_history", dev).long()
        preds = _stack(rows, "prediction", dev).long()
        R, U, _ = branches.shape
        M = self.cfg["mel_dim"]
        enc = self.encode(toks, il)
        side = {k: self.ref.v1_enc_side(self.P, enc[k], n)
                for k, n in self.nums.items()}
        z = lambda *s: torch.zeros(R, W, *s, device=dev)
        state = {k: self.ref.v1_state(self.cfg, R, W, dev)
                 for k in self.nums}
        prev = {k: z(M) for k in self.nums}
        hist = {k: z() for k in self.nums}
        t = torch.zeros(R, W, dtype=torch.long, device=dev)
        u = torch.zeros_like(t)
        fin = torch.zeros(R, W, dtype=torch.bool, device=dev)
        label = torch.zeros_like(t)
        alt = torch.zeros(R, W, device=dev)
        mels = {k: torch.empty(R, U, W, M, device=dev) for k in self.nums}
        gap = {k: torch.zeros(R, device=dev) for k in self.nums}
        invalid, mism = (torch.zeros((), dtype=torch.long, device=dev)
                         for _ in range(2))
        rix = torch.arange(R, device=dev)[:, None]
        for s in range(U):
            out = {k: self.ref.v1_step(self.P, side[k], t, state[k], prev[k],
                                       n)
                   for k, n in self.nums.items()}
            cand = {k: beam.v1_candidates(hist[k], out[k][0], t, u, fin, il)
                    for k in self.nums}
            c = cand["ref"]
            par, pr = branches[:, s], preds[:, s]
            k = (pr == beam.SHIFT).long()
            dv = c["valid"] & _first(label)[..., None]
            at_last = c["active"] & c["last"]
            amb = at_last.gather(1, par) & (pr == beam.EMIT)
            if bool(amb.any()):
                k = self._resolve(k, amb, par, label, pr)
                # The other of the two finishing emits: its log-prob lies
                # h_emit away (k = 1 kept hist, k = 0 added h_emit).
                h_emit = out["ref"][0][..., beam.EMIT].gather(1, par)
                step_alt = torch.where(amb, torch.where(k == 1, h_emit,
                                                        -h_emit), 0.0)
            else:
                step_alt = 0.0
            alt = alt.gather(1, par) + step_alt
            mism += (t_hist[:, s] != t.gather(1, par)).sum()
            mism += (pr != _take(c["pred"], par, k)).sum()
            ok = _take(c["valid"], par, k)
            invalid += (~ok).sum()
            sel = _selected(label, par, k, 2)
            m = torch.minimum(dv.flatten(1).sum(1), torch.tensor(W))
            twins = _twins(c, sel, dv, V1_FIELDS,
                           lambda lp: self.limits["lp_rel"] * _scale(lp))
            # Which of the two finishing emits a slot holds does not show
            # in the outputs: either excuses the other.
            twins |= (at_last & (sel[..., 0] | sel[..., 1]))[..., None]
            for key in self.nums:
                pick = sel if key == "ref" else _top(cand["ctl"]["lp"], dv, m)
                gap[key] = torch.maximum(gap[key], _inversion(
                    c["lp"], pick, dv, twins if key == "ref" else None,
                    _scale))
            fin_prev = fin.gather(1, par)
            t, u = _take(c["nt"], par, k), _take(c["nu"], par, k)
            fin = _take(c["fin"], par, k)
            for key in self.nums:
                hist[key] = _take(cand[key]["lp"], par, k)
                g = lambda x: x[rix, par]
                state[key] = g(out[key][2])
                frame = torch.where((fin & fin_prev)[..., None],
                                    g(prev[key]), g(out[key][1]))
                prev[key] = frame
                mels[key][:, s] = frame
            label = _relabel(label, par, k, 2)
        slots, ts = beam.best_path(torch.zeros(R, dtype=torch.long,
                                               device=dev), branches, t_hist)
        mism += (ts != _stack(rows, "alignment", dev).long()).sum()
        mism += (u[:, 0] != _stack(rows, "num_frames", dev).long()).sum()
        best = {key: self.ref.v1_output(
            self.P, self.cfg,
            mels[key][rix, torch.arange(U, device=dev)[None], slots],
            u[:, 0], n) for key, n in self.nums.items()}
        scale = best["ref"].square().mean().sqrt().clamp(min=1e-12)
        prog_mel = _stack(rows, "mel", dev).float()
        prog_lp = _stack(rows, "log_prob", dev).float()
        mel = {key: float((m - best["ref"]).abs().max() / scale)
               for key, m in (("ref", prog_mel), ("ctl", best.get("ctl")))
               if m is not None}
        return self._numbers(gap, prog_lp, hist, invalid, mism, mel, alt,
                             relative=True)

    @staticmethod
    def _resolve(k, amb, par, label, pr):
        """At the last source position a beam's two candidates are both
        finishing emits, alike but for the log-prob: the one that keeps it
        ranks first. The slots after the survivors repeat them from the
        front, so the survivors are the shortest prefix whose repetition
        gives every slot."""
        k = k.clone()
        keys = (label.gather(1, par) * 2 + pr).tolist()
        W = k.shape[1]
        for r in torch.nonzero(amb.any(1))[:, 0].tolist():
            row = keys[r]
            n = next(p for p in range(1, W + 1)
                     if all(row[j] == row[j - p] for j in range(p, W)))
            seen = set()
            for j in range(W):
                if j >= n:
                    k[r, j] = k[r, j - n]
                elif bool(amb[r, j]):
                    k[r, j] = 0 if row[j] in seen else 1
                    seen.add(row[j])
        return k

    def v2(self, rows: List[dict], W: int, max_frames: int,
           duration_table) -> Dict[str, dict]:
        dev = self.device
        toks = _stack(rows, "tokens", dev).long()
        il = _stack(rows, "input_length", dev).long()
        ol = _stack(rows, "target_length", dev).long()
        branches = _stack(rows, "beam_branch", dev).long()     # (R, T, W)
        preds = _stack(rows, "prediction", dev).long()
        dtab = torch.as_tensor(duration_table, device=dev).long()
        R, T, _ = branches.shape
        D = dtab.shape[0]
        enc = self.encode(toks, il)
        side = {k: self.ref.v2_enc_side(self.P, enc[k], n)
                for k, n in self.nums.items()}
        state = {k: self.ref.v2_state(self.cfg, R, W, dev)
                 for k in self.nums}
        hist = {k: torch.zeros(R, W, device=dev) for k in self.nums}
        zl = lambda: torch.zeros(R, W, dtype=torch.long, device=dev)
        t, u, tot, pc, label = zl(), zl(), zl(), zl(), zl()
        fin = torch.zeros(R, W, dtype=torch.bool, device=dev)
        emptied = torch.zeros(R, dtype=torch.bool, device=dev)
        gap = {k: torch.zeros(R, device=dev) for k in self.nums}
        invalid, mism = (torch.zeros((), dtype=torch.long, device=dev)
                         for _ in range(2))
        rix = torch.arange(R, device=dev)[:, None]
        last_slot = torch.arange(W, device=dev) == W - 1
        for s in range(T):
            pos = torch.minimum(torch.tensor(s, device=dev), il - 1)
            pos = pos[:, None].expand(R, W)
            out = {k: self.ref.v2_step(self.P, side[k], pos, state[k], pc, n)
                   for k, n in self.nums.items()}
            cand = {k: beam.v2_candidates(hist[k], out[k][0], t, u, tot,
                                          fin, dtab, il, ol)
                    for k in self.nums}
            c = cand["ref"]
            par, pr = branches[:, s], preds[:, s]
            k = torch.where(c["active"].gather(1, par), pr,
                            torch.zeros_like(pr))
            dv = c["valid"] & _first(label)[..., None]
            alive = dv.flatten(1).any(1)
            emptied |= ~alive
            mism += (pr != _take(c["pred"], par, k)).sum()
            ok = _take(c["valid"], par, k)
            diag_pool = dv & c["diag"]
            has_diag = diag_pool.flatten(1).any(1)
            main = ~(has_diag[:, None] & last_slot)
            ok = ok & (main | _take(c["diag"], par, k))
            invalid += (~ok & alive[:, None]).sum()
            sel = _selected(label, par[:, :W - 1], k[:, :W - 1], D)
            sel = torch.where(has_diag[:, None, None], sel,
                              _selected(label, par, k, D))
            lim = self.limits["lp_err"]
            twins = _twins(c, sel, dv, V2_FIELDS,
                           lambda lp: torch.full_like(lp, lim))
            wmain = torch.where(has_diag, W - 1, W)
            m = torch.minimum(dv.flatten(1).sum(1), wmain)
            best_diag = torch.where(diag_pool, c["lp"], -torch.inf)
            best_diag = best_diag.flatten(1).amax(1)
            for key in self.nums:
                if key == "ref":
                    pick = sel
                    kept = _take(c["lp"], par, k)[:, -1]
                else:
                    pick = _top(cand["ctl"]["lp"], dv, m)
                    cl = torch.where(diag_pool, cand["ctl"]["lp"], -torch.inf)
                    kept = c["lp"].flatten(1).gather(
                        1, cl.flatten(1).argmax(1, keepdim=True))[:, 0]
                g = _inversion(c["lp"], pick, dv,
                               twins if key == "ref" else None)
                g = torch.where(has_diag, torch.maximum(
                    g, (best_diag - kept).clamp(min=0.0)), g)
                gap[key] = torch.maximum(gap[key], torch.where(alive, g, 0.0))
            t, u = _take(c["nt"], par, k), _take(c["nu"], par, k)
            tot, fin = _take(c["tot"], par, k), _take(c["fin"], par, k)
            for key in self.nums:
                hist[key] = _take(cand[key]["lp"], par, k)
                state[key] = out[key][1][rix, par]
            pc = pr
            label = _relabel(label, par, k, D)
        order = beam.ancestry(branches)                          # (R, W, T)
        classes = preds.transpose(1, 2).gather(1, order)
        within = torch.arange(T, device=dev)[None, None] < il[:, None, None]
        durations = torch.where(within, dtab[classes], 0)
        out_len = durations.sum(-1)
        src = beam.source_indexes(durations, out_len, max_frames)
        for name, ref in (("ordered_beam_branch", order),
                          ("durations", durations),
                          ("output_length", out_len),
                          ("source_indexes", src), ("total_duration", tot),
                          ("is_finished", fin), ("beam_emptied", emptied)):
            mism += (_stack(rows, name, dev).long() != ref.long()).sum()
        return self._numbers(gap, _stack(rows, "log_prob", dev).float(),
                             hist, invalid, mism)

    @staticmethod
    def _numbers(gap, prog_lp, hist, invalid, mism, mel=None, alt=None,
                 relative=False):
        """{"program": numbers, "control": numbers (empty without it)}.
        alt: where a final slot's ancestry finished at the last source
        position, how far the other finishing emit's log-prob lies; the
        program's log-prob is held to the nearer of the two. relative:
        the log-prob numbers over _scale of the reference's (v1:
        sel_rel, lp_rel), else in nats (v2: sel_gap, lp_err)."""
        d = (prog_lp - hist["ref"]).abs()
        if alt is not None:
            d = torch.minimum(d, (prog_lp - hist["ref"] - alt).abs())
        div = _scale(hist["ref"]) if relative else 1.0
        sel, lp = ("sel_rel", "lp_rel") if relative else ("sel_gap", "lp_err")
        prog = {sel: float(gap["ref"].max()), lp: float((d / div).max()),
                "invalid": float(invalid), "mismatches": float(mism)}
        ctl = {}
        if "ctl" in gap:
            ctl = {sel: float(gap["ctl"].max()),
                   lp: float(((hist["ctl"] - hist["ref"]).abs() / div).max())}
        if mel is not None:
            prog["mel_err"] = mel["ref"]
            if "ctl" in mel:
                ctl["mel_err"] = mel["ctl"]
        return {"program": prog, "control": ctl}


def judge(ref, entry: str, params, cfg: dict, rows: List[dict],
          workload: dict, traffic: dict, device, control: bool = False
          ) -> Dict[str, dict]:
    """The program's numbers over the sampled rows and, with `control`,
    the control's, by `ref`, the architecture's reference module; the
    reference's float32 matrix products without TF32."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            j = Judge(ref, params, cfg, device, control, workload["limits"])
            if entry == "v1":
                return j.v1(rows, traffic["beam"])
            return j.v2(rows, traffic["beam"], traffic["max_frames"],
                        cfg["duration_table"])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct when every number is within its limit."""
    return all(numbers[k] <= limits[k] for k in limits)
