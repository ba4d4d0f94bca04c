"""Typed configuration for every model variant.

A copy of the JAX package's ``config.py`` (the port imports nothing from that
package). Field names, defaults and the variant table are identical, so a
config built here describes the same model as the JAX package's config of the
same name:

  vanilla / lr_sh -> SBERT text, plain conv-transpose decoder
  unet            -> char BiGRU text, U-Net decoder
  v2              -> char BiGRU, U-Net + SpatialFiLM, KL anneal
  oldv            -> char BiGRU + conv1d + positional encoding, 3-level U-Net,
                     gated skips

``compute_dtype`` selects float32 (the parity mode: TF32 off) or bfloat16
(convolutions in bf16; BatchNorm statistics, the GRU and the outputs in f32).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# PAD token is index 0; out-of-vocabulary characters map to PAD.
ASCII_ALPHABET = (
    " !\"#$%&'()*+,-./0123456789:;<=>?@ABCDEFGHIJKLMNOPQRSTUVWXYZ[\\]^_`"
    "abcdefghijklmnopqrstuvwxyz{|}~"
)
CYRILLIC = (
    "абвгдеёжзийклмнопрстуфхцчшщъыьэюя"
    "АБВГДЕЁЖЗИЙКЛМНОПРСТУФХЦЧШЩЪЫЬЭЮЯ"
)
ASCII_CYRILLIC_ALPHABET = ASCII_ALPHABET + CYRILLIC

MAX_TEXT_LEN = 60


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """ReduceLROnPlateau on the validation reconstruction loss."""

    factor: float = 0.95
    patience: int = 15
    threshold: float = 1e-4
    min_lr: float = 1e-7


@dataclasses.dataclass(frozen=True)
class VariantConfig:
    name: str = "v2"

    # --- geometry ---
    patch_h: int = 64
    patch_w: int = 448
    in_ch: int = 4          # RGB image + mask
    out_ch: int = 3
    z_ch: int = 128

    # --- text conditioning ---
    # "sbert": precomputed 384-d sentence embedding -> Linear -> 64,
    #          spatially broadcast at the bottleneck.
    # "char": char embedding -> 2-layer BiGRU -> adaptive pool to W/16.
    # "char_posenc": char path + Conv1d + learnable 2-D positional encoding,
    #         output height 4.
    text_encoder: str = "char"
    alphabet: str = ASCII_ALPHABET
    max_text_len: int = MAX_TEXT_LEN
    sbert_dim: int = 384
    text_ch: int = 64
    char_emb_dim: int = 128
    char_rnn_hidden: int = 256  # per direction; BiGRU output = 512
    char_rnn_layers: int = 2
    char_rnn_dropout: float = 0.1
    text_feature_height: int = 1  # oldv uses 4

    # --- generator architecture ---
    # "plain": conv stack encoder + conv-transpose decoder (vanilla / lr_sh)
    # "unet":  4-level U-Net with concat skips
    # "film4": 4-level U-Net + SpatialFiLM at every stage (v2)
    # "film3": 3-level U-Net + gated skips + SpatialFiLM (oldv)
    generator: str = "film4"
    enc_chans: Tuple[int, ...] = (64, 128, 256, 512)   # oldv: (32, 64, 128)
    bottleneck_ch: int = 1024                          # oldv: 256

    # --- losses ---
    recon_weight: float = 1.0
    kl_weight: float = 0.001
    gan_weight: float = 0.15
    perc_weight: float = 0.1
    kl_anneal_epochs: int = 0
    start_kl_weight: float = 1e-7

    # --- optimization ---
    batch_size: int = 16
    epochs: int = 200
    save_every: int = 1
    lr_g: float = 1e-4
    lr_d: float = 1e-4
    adam_b1: float = 0.5
    adam_b2: float = 0.999
    grad_clip_norm: float = 1.0   # applied to G only
    scheduler: Optional[SchedulerConfig] = None

    # --- evaluation ---
    full_loss_val: bool = False

    # --- execution knobs ---
    compute_dtype: str = "bfloat16"   # "float32" for parity tests
    fused_disc_forward: bool = True
    remat_encoder: bool = False
    conditional_disc: bool = False
    # Exact row-factored SpatialFiLM predictor for height-1 text maps.
    fast_film: bool = True
    # --- data ---
    val_split: float = 0.1
    split_seed: int = 42

    @property
    def vocab_size(self) -> int:
        return len(self.alphabet) + 1  # +1 for PAD at index 0

    @property
    def num_levels(self) -> int:
        return len(self.enc_chans)

    @property
    def latent_h(self) -> int:
        return self.patch_h // (2 ** self.num_levels)

    @property
    def latent_w(self) -> int:
        return self.patch_w // (2 ** self.num_levels)

    @property
    def text_feature_width(self) -> int:
        # Always W/16, even for the 3-level oldv generator.
        return self.patch_w // 16

    def validate(self) -> "VariantConfig":
        if self.patch_h % (2 ** self.num_levels) or \
                self.patch_w % (2 ** self.num_levels):
            raise ValueError(f"patch {self.patch_h}x{self.patch_w} not "
                             f"divisible by 2^{self.num_levels}")
        if self.patch_w % 16:
            raise ValueError("text feature width is patch_w // 16")
        if self.text_encoder not in ("sbert", "char", "char_posenc"):
            raise ValueError(f"text_encoder {self.text_encoder!r}")
        if self.generator not in ("plain", "unet", "film4", "film3"):
            raise ValueError(f"generator {self.generator!r}")
        return self


VARIANTS = {
    "vanilla": VariantConfig(
        name="vanilla", text_encoder="sbert", generator="plain",
        enc_chans=(128, 256, 512, 1024), bottleneck_ch=1024,
        kl_weight=0.005, gan_weight=0.1, perc_weight=0.05,
        lr_g=1e-4, lr_d=1e-4, epochs=150, scheduler=None,
        full_loss_val=False,
    ),
    "lr_sh": VariantConfig(
        name="lr_sh", text_encoder="sbert", generator="plain",
        enc_chans=(128, 256, 512, 1024), bottleneck_ch=1024,
        kl_weight=0.001, gan_weight=0.1, perc_weight=0.2,
        lr_g=1e-4, lr_d=5e-5, epochs=200, scheduler=SchedulerConfig(),
        full_loss_val=True,
    ),
    "unet": VariantConfig(
        name="unet", text_encoder="char", generator="unet",
        alphabet=ASCII_CYRILLIC_ALPHABET,
        enc_chans=(64, 128, 256, 512), bottleneck_ch=1024,
        kl_weight=0.001, gan_weight=0.15, perc_weight=0.1,
        lr_g=1e-4, lr_d=1e-4, epochs=200, scheduler=SchedulerConfig(),
        full_loss_val=False,
    ),
    "v2": VariantConfig(
        name="v2", text_encoder="char", generator="film4",
        alphabet=ASCII_ALPHABET,
        enc_chans=(64, 128, 256, 512), bottleneck_ch=1024,
        kl_weight=0.001, gan_weight=0.15, perc_weight=0.1,
        kl_anneal_epochs=20, start_kl_weight=1e-7,
        lr_g=1e-4, lr_d=1e-4, epochs=200, scheduler=SchedulerConfig(),
        full_loss_val=True,
    ),
    "oldv": VariantConfig(
        name="oldv", text_encoder="char_posenc", generator="film3",
        alphabet=ASCII_ALPHABET, text_feature_height=4,
        enc_chans=(32, 64, 128), bottleneck_ch=256,
        kl_weight=0.001, gan_weight=0.07, perc_weight=0.2,
        kl_anneal_epochs=15, start_kl_weight=1e-7,
        lr_g=1e-4, lr_d=5e-5, epochs=200, scheduler=SchedulerConfig(),
        full_loss_val=True,
    ),
}


def get_config(name: str, **overrides) -> VariantConfig:
    """Variant config with overrides. Dotted keys reach into nested
    dataclasses: ``get_config("v2", **{"scheduler.patience": 5})``.
    """
    cfg = VARIANTS[name]
    if overrides:
        flat, nested = {}, {}
        for k, v in overrides.items():
            if "." in k:
                head, _, sub = k.partition(".")
                nested.setdefault(head, {})[sub] = v
            else:
                flat[k] = v
        for head, subs in nested.items():
            cur = flat.get(head, getattr(cfg, head))
            if cur is None:
                raise ValueError(
                    f"variant {name!r} has {head}=None; set the whole "
                    f"object before {head}.<field> overrides")
            flat[head] = dataclasses.replace(cur, **subs)
        cfg = dataclasses.replace(cfg, **flat)
    return cfg.validate()
