"""Plain float32 references, one file a model family: ``<family>.py``
gives ``kinds(model)``, the (mixer, ffn, global) kind of every layer, and
:mod:`cellbench.reference.decoder` computes with it. Nothing here imports
the program."""
import importlib


def family(name: str):
    """The reference module of a family (``ssm``, ``hybrid``, ...)."""
    return importlib.import_module(f"cellbench.reference.{name}")
