"""The edit, plainly: DDIM inversion of a clip, then chunked classifier-free
guided DDIM sampling with VidToMe merging (and PnP), then the VAE decode.

What the edit derives from its inputs is worked out here again from the
same inputs and the configured seed: the DDIM tables, the chunk schedule
(rotated boundaries, a mix-order permutation of the chunks, drawn from
``numpy.random.default_rng(seed)``), the merge draws (a dst frame per local
round and a coin per UNet call, from ``torch.Generator().manual_seed(seed)``
in that order), and the prompt token ids.  Everything is float32.
"""

from __future__ import annotations

import dataclasses
import html
import re
import zlib

import numpy as np
import torch

from benchmark.reference import merge as M
from benchmark.reference import sd


# ------------------------------------------------------------------ DDIM


def ddim_tables(steps: int, train_steps: int = 1000):
    """(timesteps descending, alphas_cumprod [1000], final alpha) of the
    scaled-linear schedule 8.5e-4 -> 1.2e-2, leading spacing, offset 1."""
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, train_steps,
                        dtype=np.float64) ** 2
    ac = np.cumprod(1.0 - betas).astype(np.float32)
    ts = ((np.arange(steps) * (train_steps // steps)).round()[::-1]
          + 1).astype(np.int64)
    return ts, ac, float(ac[0])


def _sq(a):
    return float(np.sqrt(np.float32(a)))


def ddim_step(x, eps, a_t, a_prev):
    """x_t -> x_{t-1}, in the dtype of x and eps."""
    x0 = (x - _sq(1 - np.float32(a_t)) * eps) / _sq(a_t)
    return _sq(a_prev) * x0 + _sq(1 - np.float32(a_prev)) * eps


def ddim_inverse_step(x, eps, a_t, a_prev):
    """x_{t-1} -> x_t, in the dtype of x and eps."""
    x0 = (x - _sq(1 - np.float32(a_prev)) * eps) / _sq(a_prev)
    return _sq(a_t) * x0 + _sq(1 - np.float32(a_t)) * eps


def unsupported(config: dict) -> list[str]:
    """The stage keys of ``config`` that this reference does not
    implement (step caches, CFG and eps schedules, controls other than
    PnP, LoRA, LDM-variant merging, a refiner, ragged chunks, the
    inversion's reconstruction), each as ``stage.key=value``."""
    bad = []
    for stage in ("inversion", "generation"):
        keys = config[stage]
        for k in ("cache_interval", "cache_schedule", "cfg_interval",
                  "cfg_schedule", "eps_interval", "eps_schedule",
                  "eps_extrapolate", "use_lora", "merge_crossattn",
                  "merge_ff", "refiner", "recon", "depth"):
            if keys.get(k):
                bad.append(f"{stage}.{k}={keys[k]!r}")
    allowed = {"inversion": ("none",), "generation": ("none", "pnp")}
    for stage, kinds in allowed.items():
        c = config[stage].get("control", "none")
        if c not in kinds:
            bad.append(f"{stage}.control={c!r}")
    b = config["generation"].get("chunk_boundaries", "rotate")
    if b != "rotate":
        bad.append(f"generation.chunk_boundaries={b!r}")
    if config.get("refiner"):
        bad.append(f"refiner={config['refiner']!r}")
    return bad


# ------------------------------------------------------------- tokenizer


def token_ids(prompts, vocab: int, length: int) -> torch.Tensor:
    """The weight-free tokenizer: BOS, crc32 of each lower-cased word,
    EOS, padded with EOS (BOS = vocab - 2, EOS = vocab - 1)."""
    out = np.full((len(prompts), length), vocab - 1, np.int64)
    for i, p in enumerate(prompts):
        text = html.unescape(html.unescape(p))
        words = re.sub(r"\s+", " ", text).strip().lower().split()[:length - 2]
        ids = [vocab - 2] + [zlib.crc32(w.encode()) % (vocab - 2)
                             for w in words] + [vocab - 1]
        out[i, :len(ids)] = ids
    return torch.from_numpy(out)


# ------------------------------------------------------ chunks and draws


def _mix_order(n, div, rng):
    rand = rng.permutation(n).tolist()
    k = int(n / div)
    seq = sorted(rand[k:])
    if k == 0:
        return seq
    rand = rand[:k]
    if abs(seq[-1] - rand[-1]) < abs(seq[0] - rand[-1]):
        seq = seq[::-1]
    return rand + seq


def chunk_table(n_frames, cs, steps, seed, chunk_ord):
    """[steps][chunks][cs] frame indices in processing order: each step
    rotates the (padded) frame axis by a random offset, flips it on a coin,
    and orders the chunks ('seq', 'rand' or 'mix-<div>')."""
    n_pad = -(-n_frames // cs) * cs
    K = n_pad // cs
    rng = np.random.default_rng(seed)
    table = []
    for _ in range(steps):
        offset = int(rng.integers(0, cs))
        order = (np.arange(n_pad) + offset) % n_pad
        if rng.random() > 0.5:
            order = order[::-1].copy()
        if K == 1 or chunk_ord == "seq":
            perm = list(range(K))
        elif chunk_ord == "rand":
            perm = rng.permutation(K).tolist()
        else:
            div = float(chunk_ord.split("-")[-1]) if "-" in chunk_ord else 3.0
            perm = _mix_order(K, div, rng)
        table.append([order[c * cs:(c + 1) * cs].tolist() for c in perm])
    return table


def merge_draws(frames, target, steps, chunks, seed):
    """[steps, chunks, rounds + 1]: a dst frame per local round, then the
    global coin in [0, 1)."""
    g = torch.Generator().manual_seed(seed)
    cols = [torch.randint(0, M.round_stride(f, target), (steps, chunks),
                          generator=g).double()
            for f in M.local_rounds(frames, target)]
    cols.append(torch.rand(steps, chunks, generator=g, dtype=torch.float64))
    return torch.stack(cols, -1).numpy()


@dataclasses.dataclass(frozen=True)
class MergeCfg:
    frames: int
    local_merge_ratio: float
    global_merge_ratio: float
    global_rand: float
    max_downsample: int
    target_stride: int
    align_batch: bool
    len_quantum: int | None


@dataclasses.dataclass
class Call:
    """One UNet call's merging state."""
    cfg: MergeCfg
    local_draws: list
    coin: float
    bank_mode: str                      # "init" or "merge"
    banks: dict
    plans: dict = dataclasses.field(default_factory=dict)


# -------------------------------------------------------------- the edit


class Edit:
    """The reference pipeline over one model, in float32, from the stage
    keys of a traffic mix's configuration."""

    def _round(self, t):
        return t.to(self.dtype).float()

    def __init__(self, unet: sd.UNet, vae: sd.VAE, text: sd.TextEncoder,
                 config: dict, dtype: torch.dtype = torch.float32):
        bad = unsupported(config)
        if bad:
            raise NotImplementedError(
                f"the reference does not implement {', '.join(bad)}: a cell "
                "with these keys needs benchmark/reference extended")
        self.unet, self.vae, self.text = unet, vae, text
        self.config = config
        # the dtype the edit hands results between its parts in (the
        # UNet's output, the guided eps): results are rounded to it there,
        # computed in float32 everywhere
        self.dtype = dtype
        self.seed = int(config["seed"])
        self.device = next(unet.parameters()).device

    def embed(self, prompts):
        cfg = self.text.cfg
        return self.text(token_ids(prompts, cfg.vocab_size,
                                   cfg.max_positions).to(self.device))

    @torch.no_grad()
    def encode(self, frames, bs=8):
        """Frames [T, H, W, 3] in [0, 1] -> clean latents [T, h, w, 4]."""
        return torch.cat([self.vae.encode(frames[i:i + bs].float())
                          for i in range(0, frames.shape[0], bs)])

    @torch.no_grad()
    def invert_eps(self, x, prompt, i):
        """The UNet's eps at inversion step ``i`` (0: the least noisy) of
        latents x [T, h, w, 4], rounded to the state dtype."""
        inv = self.config["inversion"]
        bs = int(inv.get("batch_size", 8))
        ctx = self.embed([prompt])
        up = ddim_tables(int(inv["steps"]))[0][::-1]
        x = x.float()
        return torch.cat([self._round(self.unet(
            x[b:b + bs], int(up[i]), ctx.expand(len(x[b:b + bs]), -1, -1)))
            for b in range(0, len(x), bs)])

    def invert_update(self, x, eps, i):
        """Inversion step ``i``'s DDIM update of x by eps, in their dtype."""
        ts, ac, final = ddim_tables(int(self.config["inversion"]["steps"]))
        up = ts[::-1]
        a_prev = ac[up[i - 1]] if i > 0 else final
        return ddim_inverse_step(x, eps, ac[up[i]], a_prev)

    def invert_timesteps(self):
        """The inversion's timesteps, in its order (least noisy first)."""
        return ddim_tables(int(self.config["inversion"]["steps"]))[0][::-1]

    def source_table(self, inverted_steps):
        """PnP's source latents at each sampling timestep, from the
        inversion's latents after each of its steps (``inverted_steps``,
        least noisy first): the step that ends at that timestep."""
        at = {int(t): j for j, t in enumerate(self.invert_timesteps())}
        steps = int(self.config["generation"]["n_timesteps"])
        return torch.stack([inverted_steps[at[int(t)]]
                            for t in ddim_tables(steps)[0]])

    def chunks(self, i, n):
        """Sampling step ``i``'s chunks of ``n`` frames, each a list of
        frame indices, in processing order."""
        gene = self.config["generation"]
        return chunk_table(n, int(gene.get("chunk_size", 4)),
                           int(gene["n_timesteps"]), self.seed,
                           gene["chunk_ord"])[i]

    def groups(self, k: int) -> list:
        """A step's UNet calls over its ``k`` chunks: (draw column, chunks
        it runs); under ``chunk_batch`` the first chunk, then the rest in
        one call."""
        if self.config["generation"].get("chunk_batch") and k > 1:
            return [(0, [0]), (1, list(range(1, k)))]
        return [(c, [c]) for c in range(k)]

    @torch.no_grad()
    def generate_calls(self, x, prompt, i, src_table=None):
        """The UNet calls of sampling step ``i`` (0: the noisiest) at
        latents x [T, h, w, 4] of every frame: each call's output, rounded
        to the state dtype, its rows lane-major ([source,] uncond, cond)
        and within a lane the frames of its chunks in the step's order.
        PnP reads ``src_table`` [steps, T, h, w, 4] (:meth:`source_table`).
        The step's chunk schedule and draws are the seed's; its first chunk
        builds every block's bank and the others (batched or one by one)
        merge against it."""
        gene = self.config["generation"]
        pnp = gene.get("control", "none") == "pnp"
        steps = int(gene["n_timesteps"])
        cs = int(gene.get("chunk_size", 4))
        n = x.shape[0]
        if n % cs:
            raise ValueError("the reference takes whole chunks")
        if not (gene["merge_global"] and gene["share_match"]):
            raise ValueError("the reference runs global merging with one "
                             "matching per level")
        mc = MergeCfg(cs, float(gene["local_merge_ratio"]),
                      float(gene["global_merge_ratio"]),
                      float(gene["global_rand"]),
                      int(gene["max_downsample"]), int(gene["target_stride"]),
                      bool(gene["align_batch"]) or pnp, gene["len_quantum"])
        table = self.chunks(i, n)
        draws = merge_draws(cs, mc.target_stride, steps, len(table),
                            self.seed)[i]
        ctx = self.embed([""] * pnp + [gene.get("negative_prompt") or "",
                                       prompt])
        L = ctx.shape[0]
        t = int(ddim_tables(steps)[0][i])
        attn = pnp and i < int(steps * float(gene.get("pnp_attn_t", 0.5)))
        conv = pnp and i < int(steps * float(gene.get("pnp_f_t", 0.8)))
        x = x.float()
        banks, outs = {}, []
        for c, chunks in self.groups(len(table)):
            if len(chunks) > 1:
                banks = {b: v.repeat_interleave(len(chunks), dim=0)
                         for b, v in banks.items()}
            call = Call(mc, [int(d) for d in draws[c][:-1]],
                        float(draws[c][-1]), "init" if c == 0 else "merge",
                        banks)
            idx = torch.tensor([f for ch in chunks for f in table[ch]],
                               device=x.device)
            F_ = len(idx)
            rows = [x[idx]] * (L - pnp)
            if pnp:
                rows.insert(0, src_table[i][idx].float())
            out = self.unet(torch.cat(rows), t,
                            ctx.repeat_interleave(F_, dim=0), call,
                            attn_inject=attn, conv_inject=conv, lanes=L)
            banks = call.banks
            outs.append(self._round(out))
        return outs

    def guide(self, i, n, outputs, dtype=torch.float32):
        """Sampling step ``i``'s guided eps of ``n`` frames from its UNet
        calls' ``outputs`` (:meth:`generate_calls`' layout), each frame's
        uncond + guidance * (cond - uncond) computed in ``dtype`` and
        rounded to the state dtype."""
        g = float(self.config["generation"]["guidance_scale"])
        table = self.chunks(i, n)
        eps = torch.zeros((n,) + tuple(outputs[0].shape[1:]),
                          device=outputs[0].device)
        for (_, chunks), out in zip(self.groups(len(table)), outputs):
            idx = [f for ch in chunks for f in table[ch]]
            F_ = len(idx)
            u, cnd = out[-2 * F_:-F_].to(dtype), out[-F_:].to(dtype)
            eps[idx] = self._round(u + g * (cnd - u))
        return eps

    def generate_update(self, x, eps, i):
        """Sampling step ``i``'s DDIM update of x by eps, in their dtype."""
        steps = int(self.config["generation"]["n_timesteps"])
        ts, ac, final = ddim_tables(steps)
        a_prev = ac[ts[i + 1]] if i + 1 < steps else final
        return ddim_step(x, eps, ac[int(ts[i])], a_prev)

    @torch.no_grad()
    def decode(self, x, bs=8):
        return torch.cat([self.vae.decode(x[i:i + bs])
                          for i in range(0, x.shape[0], bs)])

