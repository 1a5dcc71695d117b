"""PyTorch/CUDA port of ``acn_tpu`` for NVIDIA Hopper (H100).

The JAX package ``acn_tpu`` is the reference: every module here mirrors a
module there by path and name (``acn_tpu_torch/occupancy/grid.py`` ↔
``acn_tpu/occupancy/grid.py``) and is held against it by the
``tests/test_torch_*.py`` parity tests. This package imports neither ``jax``
nor ``acn_tpu``.

What is ported so far: full frames of the K-expert model through
``pipelines.renderer.Renderer`` (``render_image`` / ``render_rays``; packed
budget, per-ray strided occupancy or stratified; soft-MoE, one expert, or
per-expert rectangles with ``render_image_routed``), the baked voxel table
(``pipelines.baking``) and videos (``pipelines.video_gen``), the FoMAML meta-training
step in every regime of a run (stratified warm-up, strided occupancy with
the would-be overflow, packed budget) through
``pipelines.offline_stage.train_step.make_meta_train_step``, the eval step,
and between steps the occupancy update and the auto-regime switch
(``pipelines.offline_stage.trainer``), the training loop, and the user's
entry point ``python -m acn_tpu_torch --op {train,eval,bake,video}``
(``runner``): the
flag parser (``utils.config``), the loaders of a prepared dataset directory
(``data``), and the eval with test-time optimization
(``pipelines.online_stage.runtime_adapt``), and the (expert × data) mesh
(``parallel``): sharded training and the frames' row-block fan-out over
processes on ``torch.distributed``. The one TPU kernel, the segmented
exclusive scan of the packed-budget paths, is a hand-written CUDA kernel for
``sm_90a`` (``csrc/segscan.cu``, bound in ``ops/segscan.py``), built with
``nvcc`` at first use into ``acn_tpu_torch/_build/``; serving launches its
forward mode, training its forward and its reverse mode.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU.
"""
