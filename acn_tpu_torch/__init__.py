"""PyTorch/CUDA port of ``acn_tpu`` for NVIDIA Hopper (H100).

The JAX package ``acn_tpu`` is the reference: every module here mirrors a
module there by path and name (``acn_tpu_torch/occupancy/grid.py`` ↔
``acn_tpu/occupancy/grid.py``) and is held against it by the
``tests/test_torch_*.py`` parity tests. This package imports neither ``jax``
nor ``acn_tpu``.

What is ported so far is the packed-budget path, served and trained: full
frames of the K-expert occupancy model through
``pipelines.renderer.Renderer`` (``render_image`` / ``render_rays``), and the
FoMAML meta-training step through
``pipelines.offline_stage.train_step.make_meta_train_step``. The one TPU
kernel on those paths, the segmented exclusive scan, is a hand-written CUDA
kernel for ``sm_90a`` (``csrc/segscan.cu``, bound in ``ops/segscan.py``),
built with ``nvcc`` at first use into ``acn_tpu_torch/_build/``; serving
launches its forward mode, training its forward and its reverse mode.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU.
"""
