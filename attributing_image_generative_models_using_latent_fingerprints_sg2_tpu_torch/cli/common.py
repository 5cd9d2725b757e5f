"""Shared CLI flag surface: the reference CLI's flag names for everything
the port carries, plus ``--device``.  A combination the reference cannot run
either (``--init encoder`` with ``--model biggan``) is refused with a clear
error instead of being ignored.
"""

from __future__ import annotations

import argparse
import os

from ..config import (
    AttackConfig,
    AttributionConfig,
    Config,
    FingerprintConfig,
    ModelConfig,
    RunConfig,
)


def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the CUDA kernels) or cpu (their plain versions)")
    p.add_argument("--model", type=str, default="sg2", choices=["sg2", "biggan"],
                   help="GAN model: sg2 | biggan (BigGAN-deep-256)")
    p.add_argument("--biggan_label", type=str, default="golden retriever",
                   help="BigGAN class: an ImageNet label name or an integer class id")
    p.add_argument("--ckpt", type=str, default="./checkpoint/550000.pt",
                   help="generator checkpoint (rosinality .pt, or .npz with the same names; "
                   "a pytorch_pretrained_biggan state dict for --model biggan)")
    p.add_argument("--random_init", action="store_true",
                   help="random generator weights instead of --ckpt")
    p.add_argument("--img_size", type=int, default=256, help="generator output size")
    p.add_argument("--style_dim", type=int, default=512, help="w-space dimensionality")
    p.add_argument("--n_mlp", type=int, default=8, help="mapping network depth")
    p.add_argument("--channel_max", type=int, default=512, help="per-resolution channel cap")
    p.add_argument("--sample_size", type=int, default=100, help="number of samples / tests")
    p.add_argument("--batch_size", type=int, default=1, help="generation batch size")
    p.add_argument("--sd", type=int, default=1, help="standard deviations moved (c)")
    p.add_argument("--key_len", type=int, default=64, help="binary key length")
    p.add_argument("--shift", type=int, default=448, help="first PC of the key carrier")
    p.add_argument("--sigma", type=float, default=1.0, help="perturb strength")
    p.add_argument("--steps", type=int, default=2000, help="optimization steps")
    p.add_argument("--n", type=int, default=20, help="Latin hypercube restarts")
    p.add_argument("--lr", type=float, default=0.2, help="attribution learning rate")
    p.add_argument("--loss", type=str, default="perceptual", help="perceptual | mse")
    p.add_argument("--save_dir", type=str, default="./result/", help="output directory")
    p.add_argument("--seed", type=int, default=0, help="global seed")
    p.add_argument("--lpips_vgg", type=str, default=None,
                   help="torchvision-format state dict of the LPIPS backbone (--lpips_net's)")
    p.add_argument("--lpips_lin", type=str, default=None,
                   help="LPIPS linear-head weights ({vgg,alex,squeeze}.pth)")
    p.add_argument("--lpips_net", type=str, default="vgg", choices=["vgg", "alex", "squeeze"],
                   help="LPIPS backbone (--lpips_vgg then names that net's torchvision state dict)")
    p.add_argument("--lpips_disc", type=str, default=None,
                   help="a trained discriminator's export (cli.train's <out>.disc.npz) as the perceptual "
                   "backbone (losses/disc_percept.py)")
    # robustness
    p.add_argument("--augmentation", type=str, default="None",
                   help="attack: None | Noise | Blur | Jpeg | Crop | Combination")
    p.add_argument("--jpeg_quality", type=int, default=50)
    p.add_argument("--noise_sigma", type=float, default=0.1)
    p.add_argument("--blur_sigma", type=float, default=0.5)
    p.add_argument("--blur_filter_size", type=int, default=25, help="Blur attack filter size")
    p.add_argument("--crop_ratio", type=float, default=0.9, help="Crop attack window ratio")
    # solver options beyond the bare solve
    p.add_argument("--attack_aware", action="store_true",
                   help="push the solver's estimate through the deterministic, differentiable "
                   "channel model of --augmentation before the loss (Noise maps to identity)")
    p.add_argument("--coarse_to_fine", action="store_true",
                   help="anneal a Gaussian blur on estimate and target during the solve (mse only)")
    p.add_argument("--ctf_sigma0", type=float, default=2.0, help="initial coarse-to-fine sigma (pixels)")
    p.add_argument("--ctf_frac", type=float, default=0.5,
                   help="fraction of steps over which the blur anneals to 0")
    p.add_argument("--polish_sweeps", type=int, default=0,
                   help="after the solve, this many greedy bit-flip sweeps over the key (0 = off)")
    p.add_argument("--polish_margin", type=float, default=0.05,
                   help="relative loss improvement a bit flip must clear")
    p.add_argument("--prune_starts", type=int, default=0,
                   help="after --prune_frac of the steps keep this many best restarts per sample (0 = off)")
    p.add_argument("--prune_frac", type=float, default=0.25,
                   help="fraction of steps all restarts run before pruning")
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype of synthesis and LPIPS in the solve: float32 | bfloat16 (mixed "
                   "precision: the optimizer state and the loss stay float32)")
    p.add_argument("--remat", action="store_true", help="gradient-checkpoint synthesis blocks")
    p.add_argument("--mesh_data", type=int, default=0,
                   help="data-parallel ranks (0 = every rank of the torchrun job; 1 = no mesh): each rank "
                   "solves or renders its rows, rank 0 writes the run's files")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="model-parallel ranks: the styled convs' output channels shard over this many "
                   "ranks (tensor parallelism; data x model must fit the torchrun job)")
    return p


def _refuse(args: argparse.Namespace) -> None:
    if getattr(args, "init", "lhs") == "encoder" and args.model != "sg2":
        raise SystemExit(f"--init encoder renders through StyleGAN2's synthesis; --model {args.model} "
                         "is not supported")


def config_from_args(args: argparse.Namespace) -> Config:
    _refuse(args)
    if args.loss not in ("perceptual", "mse"):
        raise SystemExit(f"--loss must be 'perceptual' or 'mse', got {args.loss!r}")
    if not args.random_init and args.ckpt and not os.path.exists(args.ckpt):
        raise SystemExit(
            f"checkpoint not found: {args.ckpt!r} (pass --ckpt PATH to a rosinality .pt, "
            "or --random_init)"
        )
    return Config(
        model=ModelConfig(
            model=args.model, img_size=args.img_size, style_dim=args.style_dim,
            n_mlp=args.n_mlp, channel_max=args.channel_max,
            ckpt=None if args.random_init else args.ckpt, biggan_label=args.biggan_label,
        ),
        fingerprint=FingerprintConfig(
            key_len=args.key_len, shift=args.shift, sigma=args.sigma, sd_moved=float(args.sd),
        ),
        attribution=AttributionConfig(
            steps=args.steps, n_starts=args.n, lr=args.lr, loss=args.loss,
            coarse_to_fine=args.coarse_to_fine, ctf_sigma0=args.ctf_sigma0, ctf_frac=args.ctf_frac,
            polish_sweeps=args.polish_sweeps, polish_margin=args.polish_margin,
            prune_starts=args.prune_starts, prune_frac=args.prune_frac,
            solver_attack=args.augmentation if args.attack_aware else "None",
        ),
        attack=AttackConfig(
            augmentation=args.augmentation, jpeg_quality=args.jpeg_quality,
            noise_sigma=args.noise_sigma, blur_sigma=args.blur_sigma,
            blur_filter_size=args.blur_filter_size, crop_ratio=args.crop_ratio,
        ),
        run=RunConfig(sample_size=args.sample_size, batch_size=args.batch_size,
                      save_dir=args.save_dir, seed=args.seed, device=args.device, dtype=args.dtype,
                      remat=args.remat, mesh_data=args.mesh_data, mesh_model=args.mesh_model),
    )


def engage_mesh(mesh_data: int, mesh_model: int, device, tag: str):
    """The CLIs' mesh rule, the reference package's: ``(mesh or None, device)``.

    A process started by torchrun (``WORLD_SIZE`` > 1) joins its process
    group (``parallel.multihost.initialize``) and runs on its rank's device.
    A mesh is built when ``mesh_data`` > 1, or when it is 0 and the world
    has more than one rank; a world of one with ``mesh_data`` 0 has none
    (and ``mesh_data`` > 1 there raises, as the reference's ``make_mesh`` does)."""
    from ..parallel import mesh as pm
    from ..parallel import multihost

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        device = multihost.initialize(device=device)
    if not (mesh_data > 1 or (mesh_data == 0 and world > 1)):
        return None, device
    mesh = pm.make_mesh(data=mesh_data, model=max(1, mesh_model))
    print(f"[{tag}] mesh: {mesh.shape} over {world} ranks ({mesh.backend})", flush=True)
    return mesh, device


def custom_lpips(args: argparse.Namespace, device):
    """The LPIPS params the flags ask for, or None without LPIPS flags: the
    discriminator of ``--lpips_disc``, else ``build_lpips_params`` on
    ``--lpips_net`` with the given files (random weights drawn from
    ``torch.Generator().manual_seed(0)``, as the reference package draws them
    from ``PRNGKey(0)``), on ``device``."""
    if args.lpips_disc:
        from ..losses.disc_percept import load_disc_percept

        return load_disc_percept(args.lpips_disc, device=device)
    if args.lpips_vgg or args.lpips_lin or args.lpips_net != "vgg":
        import torch

        from ..losses.lpips import build_lpips_params

        return build_lpips_params(torch.Generator().manual_seed(0), device, args.lpips_vgg, args.lpips_lin,
                                  net=args.lpips_net)
    return None


def resolve_lpips(args: argparse.Namespace, cfg: Config, want: bool = True):
    """The LPIPS wiring of the solving CLIs: ``(want_default, custom_params)``.
    Pass the first to ``build_pipeline(want_lpips=...)`` and the second, where
    not None, as its ``lpips_params``.  A perceptual run with LPIPS flags gets
    :func:`custom_lpips` on ``cfg.run.device``; ``want=False`` (a run that
    solves nothing) and the mse loss build no LPIPS."""
    if not (want and cfg.attribution.loss == "perceptual"):
        return False, None
    params = custom_lpips(args, cfg.run.device)
    return params is None, params
