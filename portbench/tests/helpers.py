"""Small configurations for the CPU tests."""
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name: str) -> dict:
    with open(os.path.join(HERE, "configs", name + ".json")) as fp:
        return json.load(fp)


def tiny(name: str, length: int = 20000, ancestors: int = 2) -> dict:
    """Overrides that cut a configuration to `ancestors` families of
    `length` bases (its k, p, rates and layout kept)."""
    cfg = config(name)
    return {"genome_length": length,
            "genomes": dict(cfg["genomes"], ancestors=ancestors)}


def tiny_config(name: str, **kw) -> dict:
    return {**config(name), **tiny(name, **kw)}
