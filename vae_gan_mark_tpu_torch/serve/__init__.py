"""Serving: a fixed-batch inference engine over the generator
(``engine.py``), and the exported artifact that serves without the model
code (``export.py``). ``InferenceEngine`` is imported at first use, so that
loading an artifact imports no module of ``models/``."""


def __getattr__(name):
    if name == "InferenceEngine":
        from vae_gan_mark_tpu_torch.serve.engine import InferenceEngine
        return InferenceEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
