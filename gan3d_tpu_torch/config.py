"""Typed configuration for gan3d_tpu_torch.

The port's own copy of the JAX package's ``Config``: every field and flag
is kept, so the same command lines parse in both packages. ``wide_conv``
and ``fast_dw`` select the hand-written k3 conv kernels, as in the JAX
package; the other fields that name a TPU lowering (``fast_*``,
``conv_dx``, ``xla_vmem_limit_kib`` ...) are accepted and the port runs
the plain op.
An option whose code path the port does not have makes the trainer raise
(``train/trainer.py``). ``async_log`` is off by default here, where the
JAX package turns it on.

``platform`` selects the device: ``""`` (default) means the CUDA card and
raises when none is present; ``"cpu"`` asks for the CPU.

Model-family precedence matches reference trainer.py:52-68:
    hybrid > dcgan > stylegan2 > stylegan > biggan-default
where ``sngan/sagan/biggan/msl`` further mutate the selected family.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

PARAMS_FILENAME = "params.json"


@dataclass
class Config:
    # ---- Hyperparameters (reference: main.py:8-19) ----
    niters: int = 5000
    batch_size: int = 16
    z_size: int = 512
    filterG: int = 128
    filterD: int = 128
    iterD: int = 2
    lrG: float = 5e-5
    lrD: float = 1e-4
    data_path: str = "lidc_train"
    steps_per_log: int = 10
    steps_per_img_log: int = 50
    log_dir: str = "log"
    load_params: bool = False

    # ---- Model family switches (reference: main.py:25-32) ----
    dcgan: bool = False
    hybrid: bool = False
    stylegan2: bool = False
    stylegan: bool = False
    msl: bool = False
    sngan: bool = False
    sagan: bool = False
    biggan: bool = False

    # ---- Loss (reference: main.py:35) ----
    hinge: bool = False

    # ---- Extras of the JAX package (no reference equivalent) ----
    resolution: int = 128       # output volume side; reference hardcodes 128
    seed: int = 0               # seeds the init and every step's noise
    # Multi-device runs are not ported: any value above 1 raises.
    num_devices: int = 0
    spatial_devices: int = 1
    model_devices: int = 1
    sync_bn: bool = True        # one device: BN statistics are the batch's
    compute_dtype: str = "bfloat16"  # activations' dtype on the card; f32
                                     # params, BN stats and SN iterations
    param_dtype: str = "float32"     # anything else raises
    remat: bool = False         # not ported: True raises
    remat_scope: str = "block"  # read only with remat
    steps_per_ckpt: int = 100   # reference checkpoints every 100 steps
    async_log: bool = False     # True: a log step's sync, FID and print
                                # wait for the next log, image or checkpoint
                                # step, the first step or the end (the
                                # values printed are the step's own); the
                                # JAX package defaults to True
    fid_in_loop: Optional[bool] = None  # axial slice FID every
                                # steps_per_log: None = when Inception
                                # weights are found (inception_weights),
                                # else warn and log nan; True = always (the
                                # random stand-in without weights); False =
                                # off
    inception_weights: str = ""  # pt_inception-2015-12-05 weights; "" =
                                 # that file name in the cwd, then log_dir
    fused_step: bool = True     # iterD D updates + 1 G update per step; the
                                # only step the port has: False raises
    adam_b1: float = 0.0        # reference: trainer.py:77-78 betas=(0., 0.9)
    adam_b2: float = 0.9
    mu_free_adam: bool = True   # b1=0 keeps no first-moment buffer (the
                                # updates are identical); False keeps one
    ema_decay: float = 0.5      # stylegan2: ema = params = d * ema +
                                # (1 - d) * params after each G update
    data_loader_workers: int = 4  # threads that assemble host batches
    profile_dir: str = ""       # set: a torch.profiler trace of steps 5-9
                                # is written there (utils/profiling.py)
    platform: str = ""          # "" = the CUDA card (raises without one);
                                # "cpu" = run on the CPU
    gp_weight: float = 0.0      # WGAN-GP weight (reference has it commented
                                # out at trainer.py:242); needs the double
                                # backward of the plain attention (CPU)
    sg2_reg_grads: bool = False  # stylegan2: True lets R1 and PL add
                                 # gradients (double backward); False, the
                                 # reference, logs their values only
    track_energy: bool = False   # energy tracking is not ported: True raises
    channel_ratio: int = 4       # BigGAN-deep bottleneck shrink factor
                                 # (reference utils.py:48 fixes 4)
    # The k3/s1/p1 convs with Ci, Co >= 8 (ops/conv3d.py), each
    # "off" | "auto" | "on" ("auto" = off, as in the JAX package):
    wide_conv: str = "auto"     # on: forward and dx by the wide-N conv
                                # kernel, dW by the dW kernel
    fast_dw: str = "auto"       # on (and wide_conv not): dW by the dW
                                # kernel, forward and dx by cuDNN
    # TPU lowering knobs of the JAX package. Accepted so the same command
    # lines parse; whatever their value the port runs the plain op.
    fast_conv: str = "auto"
    fast_upconv: str = "auto"
    fast_downconv: str = "auto"
    downconv_vjp: str = "auto"
    fast_stem: str = "auto"
    fast_head: str = "auto"
    fast_fir: str = "auto"
    fast_c1: str = "auto"
    fast_tri: str = "auto"
    conv_dx: str = "auto"
    fast_adain: str = "auto"
    fast_pix: str = "auto"
    xla_vmem_limit_kib: int = -1
    wire_dtype: str = "auto"     # real batches are uploaded in f32
    # Multi-host runs are not ported: distributed=True raises.
    distributed: bool = False
    coordinator_address: str = ""
    process_id: int = -1
    num_processes: int = 0

    # ------------------------------------------------------------------
    def family(self) -> str:
        """Resolved model family per reference precedence (trainer.py:52-68)."""
        if self.hybrid:
            return "hybrid"
        if self.dcgan:
            return "dcgan"
        if self.stylegan2:
            return "stylegan2"
        if self.stylegan:
            return "stylegan"
        return "biggan"  # covers sngan / sagan / biggan flag variants

    # ------------------------------------------------------------------
    # Derived architecture helpers. The reference hardcodes 128^3; we derive
    # the same channel patterns for any power-of-two resolution >= 8 so the
    # 32^3 / 64^3 BASELINE configs work with the identical topology at 128.
    # ------------------------------------------------------------------
    @property
    def num_up_stages(self) -> int:
        """Stride-2 stages from the 4^3 stem to `resolution`."""
        r, n = self.resolution, 0
        assert r >= 8 and (r & (r - 1)) == 0, "resolution must be 2^k >= 8"
        while r > 4:
            r //= 2
            n += 1
        return n

    def dcgan_g_channels(self) -> List[int]:
        """Per-stage output channels for the DCGAN G, stem first.

        At 128^3 reproduces reference dcgan.py:17-70:
        [ngf*16, ngf*8, ngf*4, ngf*2, ngf] then 1 output channel.
        """
        s = self.num_up_stages  # stem + (s-1) inner stages + final to 1ch
        return [self.filterG * (1 << (s - 1 - i)) for i in range(s)]

    def dcgan_d_channels(self) -> List[int]:
        """Per-stage output channels for the DCGAN D (mirror of G).

        At 128^3 reproduces reference dcgan.py:117-182:
        [ndf, ndf*2, ndf*4, ndf*8, ndf*16] then a 4^3 conv to 1.
        """
        s = self.num_up_stages
        return [self.filterD * (1 << i) for i in range(s)]

    def biggan_g_arch(self) -> Dict[str, Any]:
        """BigGAN-3D G architecture dict (reference: biggan.py:14-17).

        At 128^3: in mults [16,16,8,4,2], out [16,8,4,2,1], resolutions
        [8..128], attention at 32.
        """
        n = self.num_up_stages
        out = [min(16, 1 << (n - 1 - i)) for i in range(n)]
        inn = [out[0]] + out[:-1]
        res = [1 << (3 + i) for i in range(n)]
        return {
            "in_channels": [m * self.filterG for m in inn],
            "out_channels": [m * self.filterG for m in out],
            "resolution": res,
            "attention": {r: (r == 32) for r in res},
        }

    def biggan_d_arch(self) -> Dict[str, Any]:
        """BigGAN-3D D architecture dict (reference: biggan.py:70-75).

        At 128^3: in mults [1,2,4,8,16], out [2,4,8,16,16], resolutions
        [64,32,16,8,4], attention at 16.
        """
        n = self.num_up_stages
        inn = [min(16, 1 << i) for i in range(n)]
        out = [min(16, 1 << (i + 1)) for i in range(n)]
        res = [self.resolution >> (1 + i) for i in range(n)]
        return {
            "in_channels": [m * self.filterD for m in inn],
            "out_channels": [m * self.filterD for m in out],
            "downsample": [True] * n,
            "resolution": res,
            "attention": {r: (r == 16) for r in res},
        }

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def save(self, log_dir: Optional[str] = None) -> str:
        path = os.path.join(log_dir or self.log_dir, PARAMS_FILENAME)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
        return path

    @classmethod
    def load(cls, log_dir: str) -> "Config":
        """Load params from a run dir — JSON first, reference pickle fallback."""
        jpath = os.path.join(log_dir, PARAMS_FILENAME)
        if os.path.isfile(jpath):
            with open(jpath) as f:
                return cls.from_dict(json.load(f))
        ppath = os.path.join(log_dir, "params.pkl")
        if os.path.isfile(ppath):
            import pickle

            with open(ppath, "rb") as f:
                ns = pickle.load(f)
            return cls.from_dict(vars(ns))
        raise FileNotFoundError(f"no {PARAMS_FILENAME} or params.pkl in {log_dir}")

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_namespace(self) -> argparse.Namespace:
        """argparse.Namespace of every field: the reference's params.pkl
        payload type (trainer.py:42-47), for the export
        (eval/export.py)."""
        return argparse.Namespace(**self.to_dict())


def add_config_flags(parser) -> None:
    """Register every Config field on an argparse parser.

    Unlike the reference (main.py uses ``type=bool`` so any value parses as
    True — SURVEY §2.3), booleans here parse 'true/false/1/0' correctly, while
    still accepting the reference's ``--biggan=True`` spelling.
    """

    def parse_bool(v: str) -> bool:
        return str(v).strip().lower() in ("1", "true", "yes", "y", "t")

    def parse_opt_bool(v: str) -> Optional[bool]:
        if str(v).strip().lower() in ("none", "auto", ""):
            return None
        return parse_bool(v)

    for f in dataclasses.fields(Config):
        arg = f"--{f.name}"
        if "Optional[bool]" in str(f.type):
            parser.add_argument(arg, type=parse_opt_bool, default=f.default,
                                nargs="?", const=True)
        elif f.type in ("bool", bool):
            parser.add_argument(arg, type=parse_bool, default=f.default, nargs="?",
                                const=True)
        else:
            ty = {"int": int, "float": float, "str": str}.get(str(f.type), str)
            parser.add_argument(arg, type=ty, default=f.default)


def config_from_args(argv=None) -> Config:
    parser = argparse.ArgumentParser(description="gan3d_tpu_torch")
    add_config_flags(parser)
    args = parser.parse_args(argv)
    return Config.from_dict(vars(args))
