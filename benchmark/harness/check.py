"""The comparison that decides ``correct``.

After the window has closed, one edit of the window, drawn from the seed,
is followed by the plain float32 reference (``benchmark/reference``, TF32
off) on the same clip, prompts and weights: stage by stage, and through
the UNet stages step by step from the program's own recorded state
(``Program.edit``), so that a number shows one layer's or one step's
error and not the drift of a whole stage.  The numbers:

* ``enc_err``: the VAE encode of a sample of the clip's frames (drawn from
  the seed), the worst frame's relative L2 distance;
* ``inv_eps_err``: at a sample of the inversion's steps (one drawn from the
  seed in each of ``check_steps`` equal spans of the schedule), the UNet's
  eps on the sampled frames (text encoder included) against the
  reference's at the program's latents: the L2 distance over all of them,
  over the same distance of the reference run in bfloat16 autocast on the
  same inputs.  That is the rounding a bf16 path makes at this seed's
  weights, which move both distances alike: a plain relative distance
  swings with the seed, this ratio much less (``PERF.md``);
* ``inv_step_err``: every inversion step's DDIM update: the program's
  latents after it against the reference's update of the program's
  latents after the step before (its encode for the first) by the
  program's eps, rounded to the state dtype: mean absolute distance over
  the update's, all frames pooled, the worst step;
* ``gen_out_err``: at a sample of the generation's steps, the output of
  each of the step's UNet calls (the merging UNet, the bank, batched
  chunks, PnP's injection from the reference's own table of the
  inversion's latents), every lane's rows and not their guided difference
  (in which the weights' rounding cancels), against the reference's at
  the program's latents, over the same distance of the reference in
  bfloat16 autocast, all calls pooled;
* ``gen_step_err``: every sampling step's guidance and DDIM update, as
  ``inv_step_err``, with the eps the reference's guidance makes of the
  program's UNet outputs (its own chunk schedule scatters them), the
  first from the inversion's last latents;
* ``dec_err``: the VAE decode of the program's last latents, the worst
  frame's RMS in [0, 1].

The control (``control=True``) is the program's own int8 (W8A8) path for
the UNet, the step below the configuration's bf16, which
``inv_eps_err`` and ``gen_out_err`` read; for what the program has no
lower path of its own for, the reference put in its place one step lower:
the VAE on float8 operands (``reference/lowp.py``) for ``enc_err`` and
``dec_err``, the guidance and DDIM update in bfloat16 arithmetic for the
step numbers.

Each number's limit is in ``benchmark/limits/<workload>.json``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import weights
from benchmark.reference import pipeline as ref_pipeline
from benchmark.reference import sd as ref_sd


def reference_modules(model: dict, seed: int, device):
    """The reference's UNet, VAE and text encoder in float32, holding the
    weights the program got (rounded to the serving dtype first)."""
    ucfg, tcfg, vcfg = ref_sd.configs_from(model)
    serve = {"bf16": torch.bfloat16, "fp32": torch.float32}[model["dtype"]]
    out = []
    for comp, make, dt in (("unet", lambda: ref_sd.UNet(ucfg), serve),
                           ("vae", lambda: ref_sd.VAE(vcfg), serve),
                           ("text", lambda: ref_sd.TextEncoder(tcfg),
                            torch.float32)):
        with torch.device("meta"):
            mod = make()
        mod = mod.to_empty(device=device).eval()
        drawn = weights.draw(weights.shapes_of(mod), comp, seed, device, dt)
        weights.load(mod, {k: v.float() for k, v in drawn.items()})
        del drawn
        out.append(mod)
    return out


def sample_frames(n: int, k: int, seed: int) -> list[int]:
    rng = np.random.default_rng(int(seed) + 7)
    return sorted(int(i) for i in rng.choice(n, size=min(k, n),
                                             replace=False))


def sample_steps(steps: int, k: int, seed: int, salt: int) -> list[int]:
    """One step drawn from the seed in each of ``k`` equal spans of the
    schedule, so that every seed checks its start, middle and end."""
    rng = np.random.default_rng(int(seed) + salt)
    k = min(k, steps)
    edges = [round(j * steps / k) for j in range(k + 1)]
    return [int(rng.integers(lo, hi)) for lo, hi in zip(edges, edges[1:])]


def _rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row relative L2 distance of a from b, rows on dim 0."""
    a, b = a.flatten(1).float(), b.flatten(1).float()
    return (a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-12)


def _rms(a: torch.Tensor, b: torch.Tensor) -> float:
    """The worst frame's RMS distance, frames on dim 0."""
    d = (a.float() - b.float()).flatten(1)
    return float(d.pow(2).mean(dim=1).sqrt().max())


def step_err(update, first: torch.Tensor, steps: list, n: int,
             eps_of=None, lower: torch.dtype | None = None) -> float:
    """The worst of a stage's DDIM updates (``steps``: the recorded
    (latents, eps, result) of each, the first ``n`` rows real): the
    program's latents after a step (its result in the state dtype) against
    ``update(before, eps, i)`` of the latents after the step before
    (``first`` for step 0) by ``eps_of(i, dtype)`` (default: the program's
    eps), in float32 and rounded to the state dtype, by mean absolute
    distance over the update's, all frames pooled.  ``lower`` computes the
    update and ``eps_of`` in that dtype instead: the control."""
    if eps_of is None:
        def eps_of(i, dtype):
            return steps[i][1][:n].to(dtype)
    worst, before = 0.0, first[:n]
    for i, (x, _, out) in enumerate(steps):
        state = x.dtype
        after = out[:n].to(state)
        ref = update(before.float(), eps_of(i, torch.float32), i)
        got = (after if lower is None
               else update(before.to(lower), eps_of(i, lower).to(lower), i))
        num = (got.float() - ref.to(state).float()).abs().mean()
        den = (ref - before.float()).abs().mean().clamp_min(1e-12)
        worst = max(worst, float(num / den))
        before = after
    return worst


@torch.no_grad()
def compare(model: dict, traffic: dict, config: dict, seed: int,
            frames: torch.Tensor, source: str, prompt: str, out: dict,
            device, control: bool = False) -> dict[str, float]:
    """The numbers compared for one edit, ``out`` being what the program's
    edit returned (``Program.edit``).  With ``control`` the program ran its
    int8 path, and the VAE and step numbers are the reference's one step
    lower (the module docstring)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        unet, vae, text = reference_modules(model, seed, device)
        edit = ref_pipeline.Edit(unet, vae, text, config,
                                 out["inv_steps"][0][0].dtype)
        n = frames.shape[0]
        keep = sample_frames(n, int(traffic["check_frames"]), seed)
        idx = torch.as_tensor(keep, device=frames.device)
        k = int(traffic["check_steps"])
        inv, gen = out["inv_steps"], out["gen_steps"]
        x0 = inv[0][0][:n]
        inverted = [o[:n].to(x.dtype) for x, _, o in inv]
        final = gen[-1][2][:n].to(gen[-1][0].dtype)
        lower = torch.bfloat16 if control else None
        got = {}

        x0_ref = edit.encode(frames[idx])
        dec_ref = edit.decode(final.float())
        got["enc_err"] = float(_rel(x0[idx], x0_ref).max())
        got["dec_err"] = _rms(out["frames"], dec_ref)
        if control:
            from benchmark.reference import lowp

            lowp.to_fp8_operands(vae)
            got["enc_err"] = float(_rel(edit.encode(frames[idx]),
                                        x0_ref).max())
            got["dec_err"] = _rms(edit.decode(final.float()), dec_ref)

        # the UNet's error over the same reference's in bfloat16 autocast
        # on the same inputs: the rounding a bf16 path makes at this seed's
        # weights, which move both alike
        low = torch.autocast(device_type=torch.device(device).type,
                             dtype=torch.bfloat16)
        num = den = 0.0
        for i in sample_steps(len(inv), k, seed, 11):
            x, eps, _ = inv[i]
            ref = edit.invert_eps(x[idx], source, i)
            with low:
                ref16 = edit.invert_eps(x[idx], source, i)
            num += float((eps[idx].float() - ref).pow(2).sum())
            den += float((ref16.float() - ref).pow(2).sum())
        got["inv_eps_err"] = (num / max(den, 1e-30)) ** 0.5
        got["inv_step_err"] = step_err(edit.invert_update, x0, inv, n,
                                       lower=lower)

        gene = config["generation"]
        pnp = gene.get("control", "none") == "pnp"
        table = edit.source_table(inverted) if pnp else None
        calls = out["gen_calls"]
        per_step = len(calls) // len(gen)
        if per_step * len(gen) != len(calls):
            raise ValueError(f"{len(calls)} UNet calls over {len(gen)} steps")

        def outputs(i):
            return calls[i * per_step:(i + 1) * per_step]

        num = den = 0.0
        for i in sample_steps(len(gen), k, seed, 13):
            ref = edit.generate_calls(gen[i][0][:n], prompt, i, table)
            with low:
                ref16 = edit.generate_calls(gen[i][0][:n], prompt, i, table)
            for pc, r, r16 in zip(outputs(i), ref, ref16, strict=True):
                if pc.shape != r.shape:
                    raise ValueError(f"UNet call of {tuple(pc.shape)} rows "
                                     f"where the reference makes "
                                     f"{tuple(r.shape)}")
                num += float((pc.float() - r).pow(2).sum())
                den += float((r16.float() - r).pow(2).sum())
        got["gen_out_err"] = (num / max(den, 1e-30)) ** 0.5
        got["gen_step_err"] = step_err(
            edit.generate_update, inverted[-1], gen, n,
            lambda i, dt: edit.guide(i, n, outputs(i), dt), lower)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return got


def judge(numbers: dict[str, float], limits: dict) -> tuple[bool, list]:
    """(correct, [(name, number, limit)]): correct when every number is
    finite and at most its limit."""
    rows = [(k, numbers[k], float(limits[k]["limit"])) for k in limits]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
