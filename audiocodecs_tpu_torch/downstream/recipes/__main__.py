"""The recipe dispatcher.

Counterpart of ``audiocodecs_tpu/downstream/recipes/__main__.py``:

    python -m audiocodecs_tpu_torch.downstream.recipes <task> task.yaml \\
        codec.yaml dataset.yaml [--key value ...] [--device cpu]

Tasks: sr, asr, ic, ks, ser, si, se, ss, slm, tts, vc (the reference's 11
recipes; ic/ks/ser/si share the classification skeleton, the task axis
selecting the label field). The arguments after the task go to the
recipe's ``main`` as they are, ``--device`` among them: without it a recipe
runs on the card, and raises where there is none.
"""

import sys

_RECIPES = {
    "sr": ("audiocodecs_tpu_torch.downstream.recipes.sr", "main"),
    "asr": ("audiocodecs_tpu_torch.downstream.recipes.asr", "main"),
    "ic": ("audiocodecs_tpu_torch.downstream.recipes.classification", "main"),
    "ks": ("audiocodecs_tpu_torch.downstream.recipes.classification", "main"),
    "ser": ("audiocodecs_tpu_torch.downstream.recipes.classification",
            "main"),
    "si": ("audiocodecs_tpu_torch.downstream.recipes.classification", "main"),
    "se": ("audiocodecs_tpu_torch.downstream.recipes.se", "main"),
    "ss": ("audiocodecs_tpu_torch.downstream.recipes.ss", "main"),
    "slm": ("audiocodecs_tpu_torch.downstream.recipes.slm", "main"),
    "tts": ("audiocodecs_tpu_torch.downstream.recipes.tts", "main"),
    "vc": ("audiocodecs_tpu_torch.downstream.recipes.vc", "main"),
}


def main(argv=None):
    import importlib

    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in _RECIPES:
        print(__doc__)
        print(f"available tasks: {', '.join(sorted(set(_RECIPES)))}")
        return 0 if argv and argv[0] in ("-h", "--help") else 2
    module, fn = _RECIPES[argv[0]]
    return getattr(importlib.import_module(module), fn)(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
