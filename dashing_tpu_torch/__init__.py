"""dashing_tpu_torch — the PyTorch/CUDA port of dashing_tpu for NVIDIA Hopper.

The JAX package `dashing_tpu` is the reference; this package mirrors its
layout so each module has an obvious counterpart:

  device      -- explicit device resolution (no silent CPU fallback)
  hashes      -- WangHash and clhash on int64 tensors (64-bit two's
                 complement)
  ops         -- encoders, HLL register update, the set sketches' device
                 steps (minhash_update), the hand-written CUDA kernels
                 (csrc/) with their plain PyTorch versions, all-pairs
                 comparison
  sketch      -- HLL and wide HLL containers and the Ertl estimator
                 family; the Bloom filter, bottom-k, b-bit MinHash,
                 HyperMinHash and SuperMinHash sketches and their numpy
                 compare engines; the exact k-mer hash sets; the
                 HeavyKeeper count filter
  pipeline    -- files -> packed tiles -> device registers
  parallel    -- several processes on torch.distributed (gloo), and the
                 cards of one host (the mesh)
  io, native  -- FASTA/FASTQ parsing, sketch names, distance-matrix files
                 (its own copies of the JAX package's host modules, C++
                 loader and HeavyKeeper, built at first use)
  metrics     -- DASHING_TPU_METRICS phase timings
  cli         -- `python -m dashing_tpu_torch.cli sketch|dist ...`

It imports neither jax nor anything of the `dashing_tpu` package, not even
the modules there that do not import jax.
"""

__version__ = "0.1.0"


class NotPorted(SystemExit):
    """A flag, mode or subcommand the port does not have yet."""

    def __init__(self, what: str):
        super().__init__(f"{what} is not yet ported to dashing_tpu_torch, "
                         "see ROADMAP.md")
