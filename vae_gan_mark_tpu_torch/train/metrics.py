"""Metric logging (a copy of the JAX package's ``train/metrics.py``).

The reference's schema: ``train/*``, ``val/*``, ``learning_rate/*`` and
``epoch`` once per epoch, plus up to 16 validation image triplets. A JSONL
file is always written; wandb only when ``WANDB_API_KEY`` is set (the
credentials come from the environment). Without Pillow, ``log_images``
makes its directory and returns without writing images, as the JAX
package's does.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class MetricsLogger:
    def __init__(self, log_dir: str, run_name: str = "run",
                 use_wandb: Optional[bool] = None, config: Optional[dict] = None):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{run_name}.metrics.jsonl")
        self._file = open(self.path, "a")
        self.summary: Dict[str, float] = {}
        self._wandb = None
        if use_wandb is None:
            use_wandb = bool(os.environ.get("WANDB_API_KEY"))
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb
                wandb.init(project=os.environ.get("WANDB_PROJECT", "VAE-GAN"),
                           name=run_name, config=config or {})
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict[str, float], step: int):
        record = {"step": step, "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_images(self, triplets, step: int, max_images: int = 16):
        """triplets: list of (ru, en, fake, caption), images (H, W, C) float
        in [0, 1]. Saved as PNGs with ``captions.txt``; to wandb too when it
        is on."""
        out_dir = os.path.join(os.path.dirname(self.path),
                               f"val_images_ep{step}")
        os.makedirs(out_dir, exist_ok=True)
        try:
            from PIL import Image
        except ImportError:
            return
        wandb_images = []
        captions = []
        for i, (ru, en, fake, caption) in enumerate(triplets[:max_images]):
            row = np.concatenate([ru, en, fake], axis=0)
            img = Image.fromarray(
                np.clip(row * 255.0, 0, 255).astype(np.uint8))
            img.save(os.path.join(out_dir, f"{i:02d}.png"))
            captions.append(f"{i:02d}.png\t{caption}")
            if self._wandb is not None:
                wandb_images.append(self._wandb.Image(img, caption=caption))
        with open(os.path.join(out_dir, "captions.txt"), "w") as f:
            f.write("\n".join(captions) + "\n")
        if self._wandb is not None and wandb_images:
            self._wandb.log({"validation/examples": wandb_images}, step=step)

    def log_model_artifact(self, checkpoint_path: str, epoch: int,
                           val_loss: float):
        """Upload the best checkpoint as a wandb artifact aliased 'best';
        nothing without wandb."""
        if self._wandb is None:
            return
        try:
            run_id = self._wandb.run.id
            artifact = self._wandb.Artifact(
                f"best-model-checkpoint-run-{run_id}", type="model",
                metadata={"epoch": epoch, "val_recon_loss": val_loss,
                          "run_id": run_id})
            artifact.add_dir(checkpoint_path)
            self._wandb.log_artifact(
                artifact, aliases=["best", f"epoch-{epoch}"])
        except Exception as e:
            print(f"wandb artifact upload failed: {e}")

    def set_summary(self, key: str, value: float):
        self.summary[key] = float(value)
        if self._wandb is not None:
            self._wandb.summary[key] = value
        summary_path = self.path.replace(".metrics.jsonl", ".summary.json")
        with open(summary_path, "w") as f:
            json.dump(self.summary, f)

    def finish(self):
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()


class NullLogger:
    """The logger of a process other than process 0 in a multi-process
    run: every process sees the same metrics, and process 0 writes them."""

    def log(self, *args, **kwargs):
        pass

    def log_images(self, *args, **kwargs):
        pass

    def log_model_artifact(self, *args, **kwargs):
        pass

    def set_summary(self, *args, **kwargs):
        pass

    def finish(self):
        pass
