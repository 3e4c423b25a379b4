"""How ``correct`` is decided: the plain reference judges what the timed path
computed, stage by stage.

On random weights a fold is ill-conditioned end to end: the CA trace
collapses, and recycling and 200 refinement steps turn rounding into Angstroms
(the port's records). So the reference recomputes each stage of the sampled
folds from the benchmark's own inputs where that is well conditioned, and
otherwise from the state the program handed to that stage (its recycled CA
trace, its distance map, its MDS embedding), and compares each stage's output:

  * ``embed``: the MSA embedding (one-hot, the vertical GRU, the residue
    biGRU) from the alignment; max |d| / max |ref|;
  * ``trunk``: the trunk layer by layer, in the sampled passes (the first,
    and one recycle drawn from the seed) of every target: the input
    layer from the reference's own pair input (DCA, the pair product, the
    pass's distance map from the program's recycled trace), each block and
    the head from the program's map before it. A whole bf16 trunk amplifies
    its rounding (a 1e-6 change of its input moves its output by about 1%
    rms, so two sound bf16 trunks part by as much), a single layer does not;
    the worst rms(d) / rms(ref) over the layers;
  * ``mds``: each pass's embedding from the program's distance map. The
    bf16 engine's subspace iteration (four rounds from a fixed basis, not
    converged on a near-degenerate tail) is recomputed for the whole batch
    and compared as the embedding's own Gram E E^T (invariant to sign and
    to rotation within a degenerate eigenspace), max |d| / max |ref|; the
    fp32 engine's ``eigh``, whose eigenvectors on a near-degenerate tail
    depend on the algorithm, is held by its backward error: each column an
    eigenpair of the Gram, with the exact k-th eigenvalue
    (``geometry.eigen_error``);
  * ``coord``: each pass's coordinate biGRU from the reference's embedding
    and the program's MDS; max |d| / max |ref|;
  * ``head``: the coordinate head's trace handed to refinement, and the best
    pass's trace handed to the final refinement, against the traces the
    reference reads off the program's biGRU outputs; max |d| in A;
  * ``conf_out``: the served confidences against sigmoid of the best pass's
    (by the mean of the program's own confidences; passes within ``TIE`` of
    the best all count as best);
  * ``refine``: both refinements from the program's input trace; the served
    CA trace against the reference's; max |d| in A;
  * ``complete``: backbone completion of the served CA trace; max |d| in A;
  * ``passes``: trunk passes missing or extra against 1 + iterations.

``control`` puts the reference itself in the program's place one precision
down (see ``Judge.judge``) on the same inputs and states, and reads the same
numbers; a sound limit lets the program pass and fails the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import features, geometry, nets

NUMBERS = ("embed", "trunk", "mds", "coord", "head", "conf_out", "refine", "complete", "passes")
CONTROLS = {"bf16": "fp8", "fp32": "tf32"}  # the trunk's next precision down, by configuration
TIE = 1e-6  # passes whose mean confidence is this close to the best's are equally best


def _rel_max(d: torch.Tensor, ref: torch.Tensor) -> float:
    return float(d.abs().max() / ref.abs().max().clamp(min=1e-30))


def _rel_rms(d: torch.Tensor, ref: torch.Tensor) -> float:
    return float(d.square().mean().sqrt() / ref.square().mean().sqrt().clamp(min=1e-30))


def _dist(ca: torch.Tensor) -> torch.Tensor:
    d = ca[:, None, :] - ca[None, :, :]
    return torch.sqrt(d.square().sum(dim=2).clamp(min=1e-8))


def _bf16(fn, *args):
    """``fn`` computed in bfloat16 on bfloat16 copies of its tensor arguments."""
    return fn(*(a.to(torch.bfloat16) if torch.is_tensor(a) else a for a in args)).float()


def _best_passes(mean_p: torch.Tensor) -> list:
    """The passes whose mean confidence ties the best's within ``TIE``."""
    return [p for p in range(len(mean_p)) if float(mean_p.max() - mean_p[p]) <= TIE]


class Judge:
    """The reference's weights and settings; ``judge`` one recorded batch."""

    def __init__(self, cfg: dict, params: dict, iterations: int, minsteps: int, device):
        self.cfg, self.p, self.device = cfg, params, torch.device(device)
        self.iterations, self.minsteps = iterations, minsteps
        self.precision = cfg["precision"]
        self._bases: dict = {}

    def _basis(self, l_pad: int) -> torch.Tensor:
        if l_pad not in self._bases:
            q = min(geometry.SUBSPACE_Q, l_pad)
            self._bases[l_pad] = torch.from_numpy(geometry.start_basis(l_pad, q)).to(self.device)
        return self._bases[l_pad]

    def embed(self, aln: torch.Tensor, precision: str) -> torch.Tensor:
        """(N, L) alignment -> (L, 512) residue embedding."""
        with nets.tf32(precision == "tf32"):
            x = torch.nn.functional.one_hot(aln.long(), self.cfg["aa_classes"]).float()
            cols = nets.vgru_final(self.p["vgru"], x)
            n = cols.shape[0]
            return nets.bigru(self.p["hgru"], cols[:, None, :],
                              torch.tensor([n], device=self.device))[:, 0]

    def trunk_layers(self, rec: dict, b: int, aln: torch.Tensor,
                     mat1d: torch.Tensor, gru_prog: list, refined0: torch.Tensor,
                     control: bool) -> float:
        """The worst rms(d) / rms(ref) over the trunk's layers in the
        recorded passes of target ``b``: the input layer from the
        reference's own pair input (features, the pair product and the
        pass's distance map, from the program's recycled trace), each block
        and the head from the program's map before it."""
        n = mat1d.shape[0]
        expected = 1 + len(self.p["trunk"]["blocks"])
        base = None
        worst = 0.0
        low = CONTROLS[self.precision] if control else None
        for p, maps in sorted(rec["layers"].items()):
            if len(maps) != expected or p >= len(rec["trunk"]):
                return math.inf
            if base is None:
                feats = features.pair_features(aln)
                base = torch.cat([mat1d[:, None, :] * mat1d[None, :, :], feats], dim=-1)
                del feats
            if p == 0:
                dmap = torch.full((n, n), -1.0, device=self.device)
            else:
                dmap = _dist(refined0 if p == 1 else gru_prog[p - 1] @ self.p["coord_fc"])
            x = torch.cat([base, dmap[..., None]], dim=-1).permute(2, 0, 1)[None]
            got = [m[b, :n, :n].to(self.device).permute(2, 0, 1)[None] for m in maps]
            tp = self.p["trunk"]
            ref = nets.input_layer(tp["input"], x, self.precision).float()
            mine = nets.input_layer(tp["input"], x, low).float() if control else got[0].float()
            worst = max(worst, _rel_rms(mine - ref, ref))
            del x
            for blk, before, after in zip(tp["blocks"], got[:-1], got[1:]):
                ref = nets.block(blk, before, self.precision).float()
                mine = nets.block(blk, before, low).float() if control else after.float()
                worst = max(worst, _rel_rms(mine - ref, ref))
            ref = nets.head(tp, got[-1], self.precision)
            mine = (nets.head(tp, got[-1], "tf32") if control else
                    rec["trunk"][p][b, :n, :n].to(self.device).permute(2, 0, 1)[None])
            worst = max(worst, _rel_rms(mine - ref, ref))
        return worst if rec["layers"] else math.inf

    def coord(self, mat1d: torch.Tensor, mds: list, precision: str) -> torch.Tensor:
        """(L, P, 512) coordinate biGRU output of every pass at once."""
        n = mat1d.shape[0]
        x = torch.stack([torch.cat([mat1d, e], dim=1) for e in mds], dim=1)
        with nets.tf32(precision == "tf32"):
            return nets.bigru(self.p["coord_gru"], x,
                              torch.full((len(mds),), n, device=self.device))

    def judge(self, rec: dict, alignments: list, results: list, control: bool = False) -> dict:
        """The numbers of one recorded batch: its original ``alignments`` and
        the ``results`` served for them ((nres, 5, 3) coords, (nres,) confs).

        With ``control`` the reference one precision down stands in for the
        program at every stage, on the same inputs and states: the trunk at
        ``CONTROLS``, the stages with products TF32 acts on (the GRUs, the
        head's product, the subspace MDS) in TF32, the others (an ``eigh``
        MDS, the choice of pass, refinement, completion) in bfloat16."""
        out = dict.fromkeys(NUMBERS, 0.0)
        passes = len(rec["trunk"])
        out["passes"] = float(abs(passes - (1 + self.iterations)))
        if passes == 0 or len(rec["refine"]) != 2 or len(rec["coord"]) != passes \
                or len(rec["mds"]) != passes or not rec["hgru"]:
            return {k: math.inf for k in NUMBERS}
        fc = self.p["coord_fc"]
        (ref1_in, ref1_out), (ref2_in, _) = rec["refine"]
        mds_ref = mds_ctl = None
        if self.precision == "bf16":
            # the subspace MDS of the whole batch at once, as the program runs it
            nres_t = torch.tensor([np.asarray(a).shape[1] for a in alignments],
                                  device=self.device)
            maps = [t[..., 0].to(self.device) for t in rec["trunk"]]
            basis = self._basis(maps[0].shape[-1])
            mds_ref = [geometry.mds_subspace(dm, nres_t, basis) for dm in maps]
            if control:
                with nets.tf32(True):
                    mds_ctl = [geometry.mds_subspace(dm, nres_t, basis) for dm in maps]
        for b, (aln_np, res) in enumerate(zip(alignments, results)):
            aln = torch.from_numpy(np.asarray(aln_np)).to(self.device)
            n = aln.shape[1]
            coords = torch.from_numpy(np.asarray(res[0])).to(self.device)
            confs = torch.from_numpy(np.asarray(res[1])).to(self.device)
            # the MSA embedding from the inputs; the trunk layer by layer
            mat1d = self.embed(aln, self.precision)
            got1d = self.embed(aln, "tf32") if control else rec["hgru"][0][:n, b].to(self.device)
            out["embed"] = max(out["embed"], _rel_max(got1d - mat1d, mat1d))
            gru_prog = [c[:n, b].to(self.device) for c in rec["coord"]]
            gap = self.trunk_layers(rec, b, aln, mat1d, gru_prog,
                                    ref1_out[b, :n].to(self.device), control)
            out["trunk"] = max(out["trunk"], gap)
            # each pass's MDS and coordinate biGRU from the program's maps and embeddings
            mds_prog = [m[b, :n].to(self.device) for m in rec["mds"]]
            for p, e_prog in enumerate(mds_prog):
                if self.precision == "bf16":
                    e_ref = mds_ref[p][b, :n]
                    e_got = mds_ctl[p][b, :n] if control else e_prog
                    g_ref = e_ref @ e_ref.T
                    gap = _rel_max(e_got @ e_got.T - g_ref, g_ref)
                else:
                    dm = rec["trunk"][p][b, :, :, 0].to(self.device)
                    e_got = (geometry.mds_eigh(dm.to(torch.bfloat16).float(), n)[:n] if control
                             else e_prog)
                    gap = geometry.eigen_error(dm, n, e_got)
                out["mds"] = max(out["mds"], gap)
            ref_gru = self.coord(mat1d, mds_prog, self.precision)
            got_gru = (self.coord(mat1d, mds_prog, "tf32") if control
                       else torch.stack(gru_prog, dim=1))
            out["coord"] = max(out["coord"], _rel_max(got_gru - ref_gru, ref_gru))
            # the best pass (the program's own confidences), the traces handed on
            conf_p = torch.stack([t[b, :n, :n, 1].to(self.device).mean(dim=1)
                                  for t in rec["trunk"]])
            ties = _best_passes(conf_p.mean(dim=1))
            if control:
                low = conf_p.to(torch.bfloat16)
                pick = int(low.float().mean(dim=1).argmax())
                confs = torch.sigmoid(low[pick]).float()
            out["conf_out"] = max(out["conf_out"], min(
                float((torch.sigmoid(conf_p[p]) - confs).abs().max()) for p in ties))
            ca_ref = [g @ fc for g in gru_prog]
            if control:
                with nets.tf32(True):
                    ca_got = [g @ fc for g in gru_prog]
                out["head"] = max(out["head"], *(float((g - r).abs().max())
                                                 for g, r in zip(ca_got, ca_ref)))
            else:
                best = [ref1_out[b, :n].to(self.device) if p == 0 else ca_ref[p] for p in ties]
                handed = ref2_in[b, :n].to(self.device)
                out["head"] = max(out["head"],
                                  float((ref1_in[b, :n].to(self.device) - ca_ref[0]).abs().max()),
                                  min(float((handed - w).abs().max()) for w in best))
            # refinement from the program's input traces; completion of the served trace
            steps = self.minsteps
            ins = [ref1_in[b, :n].to(self.device), ref2_in[b, :n].to(self.device)]
            refs = [geometry.refine(x, steps) for x in ins]
            gots = ([_bf16(geometry.refine, x, steps) for x in ins] if control
                    else [ref1_out[b, :n].to(self.device), coords[:, 1]])
            out["refine"] = max(out["refine"], *(float((g - r).abs().max())
                                                 for g, r in zip(gots, refs)))
            done = geometry.complete(coords[:, 1])
            got_done = _bf16(geometry.complete, coords[:, 1]) if control else coords
            out["complete"] = max(out["complete"], float((got_done - done).abs().max()))
        return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in shown.values())
    return ok, shown


def worst(readings: list) -> dict:
    """The largest reading of each number over several batches."""
    return {k: max((r[k] for r in readings), default=math.inf) for k in NUMBERS}
