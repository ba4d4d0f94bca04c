"""The plain reference of what the benchmark runs: plain torch, imports
nothing of the program under test.

Shared by every configuration: ``model.py`` (building blocks, the
discriminator, the VGG head), ``precision.py``, ``train.py`` (the GAN step,
validation, Adam) and ``serve.py``. The generator is the architecture's:
each configuration file names its module, ``"reference": "<module>"`` for
``reference/<module>.py``, and the harness reaches the generator, its text
inputs and its work count only through that module. A module gives:

* ``Generator(cfg)``: ``(ru, mask, text, eps=None, generator=None) ->
  (recon, mu, logvar)``, with the program's state-dict keys; each leaf
  carries ``init`` for the weight maker (``model.param``);
* ``text_inputs(cfg, strings, device)``: the ``text`` tensor that its
  ``Generator`` and the program's Trainer take for those strings;
* ``example_text(cfg, rows)``: the stand-in ``text`` of the work count,
  made on the current (meta) device;
* ``fix_weights(g_sd)``: what the seeded draws need set after them;
* ``TEXT_PREFIXES``: the generator's leaves of the text path, by key
  prefix;
* ``F32_MODULES``: suffixes of the generator's module names counted at
  float32's peak;
* ``counted(cfg)``: the context in which the work is counted.

A new architecture adds its module, a configuration file that names it,
and entries in ``BENCHMARK.json``: no file of the harness changes.
"""
