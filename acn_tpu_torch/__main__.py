"""``python -m acn_tpu_torch --op {train,eval,video,view,bake} ...``: the
port's entry point, ``runner.main`` on the card (the counterpart of
``nerf_runner.py``).
"""

if __name__ == "__main__":
    from acn_tpu_torch.runner import main

    main()
