"""Scaled-down runs of the families served since qwen1.5: the weight
scales and the window shared by ``tests/test_torch_families.py`` and
``chip_smoke.py`` (which reads this file on the card, so it imports
nothing: no jax, no torch).

``FAMILY_SCALES`` gives, for each arch, (embedding scale, scale of every
other weight) on the init weights: at the init scale (0.02) the
attention families repeat one token per request.  gemma2's sandwich
norms make each block's output unit-RMS whatever its weights, so its
blocks need x8 while its tied, sqrt(d)-scaled embedding stays at x1
(larger, the last token's own row wins the tied head); zamba2's streams
vary at the init scale.  deepseek-v2 (``tests/test_torch_mla.py``) is
not one of ``ARCHS``: its entry is its scale alone.  gemma2 and llava run
with ``local_window`` ``WINDOW``, which the scaled-down prompts exceed.
"""

ARCHS = ("qwen1_5_4b", "chatglm3_6b", "gemma2_9b", "llava_next_mistral_7b",
         "zamba2_7b")
FAMILY_SCALES = {"qwen1_5_4b": (4.0, 4.0), "chatglm3_6b": (4.0, 4.0),
                 "gemma2_9b": (1.0, 8.0),
                 "llava_next_mistral_7b": (4.0, 4.0),
                 "zamba2_7b": (1.0, 1.0),
                 # served since deepseek-v2 (tests/test_torch_mla.py): its
                 # scaled-down streams vary at x4
                 "deepseek_v2_236b": (4.0, 4.0)}
#: a window the scaled-down runs exceed, and the archs that take it
WINDOW = 16
WINDOWED = ("gemma2_9b", "llava_next_mistral_7b")


def family_config(registry, arch: str):
    """The scaled-down config of ``arch`` from ``registry`` (the
    reference's or the port's ``configs``), with ``WINDOW`` where the
    arch has a local window."""
    kw = {"local_window": WINDOW} if arch in WINDOWED else {}
    return registry.get(arch).scaled_down(**kw)
