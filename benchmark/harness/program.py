"""The system under test: ``vidtome_torch``'s two stages, in process.

The edit the window drives is what ``cli.run_inversion`` and
``cli.run_generation`` run, without their disk round trip:
``Inverter(bundle, config)(frames)`` (VAE encode, text encoder, DDIM
inversion; under PnP every timestep's latents kept in memory), then
``Generator.sample`` over the padded inverted latents (chunked DDIM sampling
with merging; under PnP with the inversion's latents at each sampling
timestep) and the VAE decode, as ``Generator.__call__`` runs them for one
prompt.  The bundle's modules are the port's, built empty and filled with
the benchmark's weights (``benchmark/harness/weights.py``).

Each DDIM update of both stages, and each UNet call of the generation, is
recorded as the stage makes it, for the check: for the length of an edit
the stages' module-level ``ddim_inverse_step`` / ``ddim_step`` are wrapped
by a recorder that keeps the latents, the eps and the update's result, and
the bundle's UNet by one that keeps each call's output (references to
tensors the stage made; no device work and no copy).
"""

from __future__ import annotations

import contextlib
import copy
import time

import torch

from benchmark.harness import weights


def _dtype(name: str) -> torch.dtype:
    return {"bf16": torch.bfloat16, "fp32": torch.float32}[name]


@contextlib.contextmanager
def no_init():
    """``torch.nn.init``'s in-place initializers as no-ops: on the meta
    device they reach ``torch._refs``, whose first call imports
    ``torch._dynamo`` (seconds of set-up), and the weights are drawn
    afterwards anyway."""
    init = torch.nn.init
    real = {n: getattr(init, n) for n in dir(init)
            if n.endswith("_") and not n.startswith("_")}
    for n in real:
        setattr(init, n, lambda t, *args, **kwargs: t)
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(init, n, fn)


def modules(model: dict):
    """The port's UNet, VAE and text encoder of a configuration file, on
    the meta device (shapes only)."""
    from vidtome_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from vidtome_torch.models.unet import UNet2DConditionModel, UNetConfig
    from vidtome_torch.models.vae import AutoencoderKL

    def tup(d):
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in d.items()}

    with torch.device("meta"), no_init():
        unet = UNet2DConditionModel(UNetConfig(**tup(model["unet"])))
        vae = AutoencoderKL(**tup(model["vae"]))
        text = CLIPTextModel(CLIPTextConfig(**model["text_encoder"]))
    return unet, vae, text


def stage_config(traffic: dict, model: dict, seed: int,
                 control: bool = False) -> dict:
    """The port's configuration of one run: the traffic's frozen stage keys,
    the model's size and precision, the run's seed (the chunk schedule and
    the merge draws); ``control`` turns on the port's own int8 (W8A8) path
    in both stages."""
    cfg = copy.deepcopy(traffic["config"])
    cfg.update(sd_version=model["sd_version"], height=model["height"],
               width=model["width"], float_precision=model["dtype"],
               seed=int(seed))
    # each edit sets its own prompts (Program.edit)
    cfg["inversion"]["prompt"], cfg["generation"]["prompt"] = "", {"edit": ""}
    if control:
        cfg["inversion"]["quant"] = cfg["generation"]["quant"] = "int8"
    return cfg


def unsupported(config: dict) -> list[str]:
    """The keys of ``config`` that :meth:`Program.edit` does not drive:
    inputs it does not make (control images, depth, LoRA files), a refiner
    stage and the inversion's reconstruction, each as ``key=value``."""
    bad = []
    inv, gen = config["inversion"], config["generation"]
    if inv.get("control", "none") != "none":
        bad.append(f"inversion.control={inv['control']!r}")
    if gen.get("control", "none") not in ("none", "pnp"):
        bad.append(f"generation.control={gen['control']!r}")
    for stage, keys in (("inversion", inv), ("generation", gen)):
        for k in ("use_lora", "refiner", "recon"):
            if keys.get(k):
                bad.append(f"{stage}.{k}={keys[k]!r}")
    version = str(config.get("sd_version")).lower()
    if "depth" in version or "xl" in version:
        bad.append(f"sd_version={config['sd_version']!r}")
    return bad


class Recorder:
    """Wraps a stage module's DDIM update (``name`` in ``module``) for the
    length of a ``with`` block and keeps (latents, eps, result) of each
    call in :attr:`steps`."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.steps: list = []

    def __enter__(self):
        self.real = real = getattr(self.module, self.name)
        steps = self.steps

        def update(x, eps, *args):
            out = real(x, eps, *args)
            steps.append((x, eps, out))
            return out

        setattr(self.module, self.name, update)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


class Calls:
    """Stands in for the bundle's UNet for the length of a ``with`` block:
    each call goes to the UNet, whose output is kept in :attr:`outputs`."""

    def __init__(self, bundle):
        self.bundle = bundle
        self.outputs: list = []

    def __call__(self, *args, **kwargs):
        out = self.unet(*args, **kwargs)
        self.outputs.append(out)
        return out

    def __getattr__(self, name):
        return getattr(self.__dict__["unet"], name)

    def __enter__(self):
        self.unet = self.bundle.unet
        self.bundle.unet = self
        return self

    def __exit__(self, *exc):
        self.bundle.unet = self.unet


class Program:
    """The port's bundle and its two stages for one run."""

    def __init__(self, model: dict, config: dict, seed: int, device,
                 sync=lambda: None):
        """Builds the bundle; :attr:`parts` holds the seconds of each part
        (the modules on the meta device, their memory on ``device`` in the
        served dtype, the weights' draw and copy, the stages)."""
        from vidtome_torch.models.registry import ModelBundle
        from vidtome_torch.models.tokenizer import load_tokenizer

        bad = unsupported(config)
        if bad:
            raise NotImplementedError(
                f"the harness does not drive {', '.join(bad)}: a cell with "
                "these keys needs benchmark/harness/program.py extended")
        self.parts = {}
        t = time.perf_counter()

        def part(name):
            nonlocal t
            sync()
            now = time.perf_counter()
            self.parts[name] = self.parts.get(name, 0.0) + now - t
            t = now

        dtype = _dtype(model["dtype"])
        unet, vae, text = modules(model)
        part("modules_s")
        built = {}
        for comp, mod, dt in (("unet", unet, dtype), ("vae", vae, dtype),
                              ("text", text, torch.float32)):
            mod = mod.to_empty(device=device).to(dt).eval()
            if any(True for _ in mod.buffers()):
                raise ValueError(f"the port's {comp} holds buffers the "
                                 "benchmark does not fill")
            part("memory_s")
            weights.load(mod, weights.draw(weights.shapes_of(mod), comp,
                                           seed, device, dt))
            part("draw_s")
            built[comp] = mod
        tcfg = model["text_encoder"]
        self.bundle = ModelBundle(
            model_key=model["name"], sd_version=model["sd_version"],
            unet=built["unet"], vae=built["vae"], text_encoder=built["text"],
            tokenizer=load_tokenizer(None, tcfg["vocab_size"],
                                     tcfg["max_positions"]),
            dtype=dtype, device=torch.device(device), random_weights=True)
        self.use(config)
        part("stages_s")

    def use(self, config: dict) -> None:
        """Build the two stages of ``config`` on the bundle."""
        from vidtome_torch.pipeline.generator import Generator
        from vidtome_torch.pipeline.inverter import Inverter

        self.config = config
        self.inverter = Inverter(self.bundle, config)
        self.generator = Generator(self.bundle, config)
        self.pnp = self.generator.use_pnp

    def edit(self, frames: torch.Tensor, source: str, prompt: str,
             stage=contextlib.nullcontext) -> dict:
        """One whole edit of ``frames`` [T, H, W, 3]: ``Inverter.__call__``,
        then ``Generator.sample`` and the decode as ``Generator.__call__``
        runs them for the one prompt.  Returns the edited frames
        [T, H, W, 3], the PnP source table the generation got (or None),
        each stage's recorded DDIM updates (``inv_steps``, ``gen_steps``:
        (latents, eps, result) a step, padded rows included) and the
        generation's UNet outputs in call order (``gen_calls``).
        ``stage(name)`` is entered around each stage."""
        from vidtome_torch.pipeline import generator, inverter

        inv, gen = self.inverter, self.generator
        inv.prompt = source
        with stage("invert"), Recorder(inverter, "ddim_inverse_step") as ri:
            inverted, _ = inv(frames)
        table = (inv.source_table(gen.scheduler.timesteps)
                 if self.pnp else None)
        dev, dt = self.bundle.device, self.bundle.dtype
        with (stage("generate"), Recorder(generator, "ddim_step") as rg,
              Calls(self.bundle) as calls):
            gen.configure_frames(inverted.shape[0])
            pad = torch.as_tensor(gen.pad_src, device=dev)
            src = None if table is None else table.to(dev, dt)[:, pad]
            clean = gen.sample(inverted.to(dev, dt)[pad], prompt,
                               src_table=src)
        edited = gen.vae.decode(clean[:gen.n_frames])
        return dict(inv_steps=ri.steps, gen_steps=rg.steps,
                    gen_calls=calls.outputs, table=table, frames=edited)

    def unet_calls(self) -> tuple[int, int]:
        """(both stages', the generation's) UNet calls of the last edit."""
        inv, gen = self.inverter.unet_calls, self.generator.unet_calls
        n_gen = gen["full"] + gen["shallow"]
        return inv["full"] + inv["shallow"] + n_gen, n_gen
