"""Inference entry point, CLI-compatible with the JAX package's ``test.py``:

    python -m buddy_tpu_torch.testing --config-name=conf_VCTK.yaml \
        tester=blind_dereverberation_BUDDy tester.checkpoint=<ckpt> \
        dset=vctk_16k_4s_test-benchmark dset.test.path=<dir> dset.test.num_examples=2

Runs on the first CUDA device; ``device=cpu`` asks for the CPU (the plain
versions of the kernels).  Relative ``model_dir`` and checkpoint paths are
taken from the directory that holds the package.  On several cards, one rank
a card (batches split over the ranks, ``testing/tester.py``):

    torchrun --standalone --nproc_per_node=<cards> -m buddy_tpu_torch.testing ...
"""

from __future__ import annotations

import os
import sys


def _main(args, device=None):
    from buddy_tpu_torch.config import instantiate
    from buddy_tpu_torch.device import resolve_device
    from buddy_tpu_torch.models import NetworkBundle
    from buddy_tpu_torch.parallel.mesh import describe
    from buddy_tpu_torch.testing.tester import Tester

    device = resolve_device(device)
    dirname = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args["model_dir"] = os.path.join(dirname, str(args["model_dir"]))
    if not os.path.exists(args["model_dir"]):
        raise FileNotFoundError(f"Model directory {args['model_dir']} does not exist")
    args["exp"]["model_dir"] = args["model_dir"]

    diff_params = instantiate(args["diff_params"])
    # inference only: the samplers take their vjps with respect to x alone
    # (buddy_tpu/sampling/dps.py:194), so the weights need no gradients
    network = NetworkBundle(instantiate(args["network"], device=device).requires_grad_(False))
    test_set = instantiate(args["dset"]["test"])
    tester = Tester(args=args, network=network, diff_params=diff_params, test_set=test_set,
                    device=device)

    print()
    print("Test options:")
    print()
    print(f"Output directory:        {args['model_dir']}")
    print(f"Network architecture:    {args['network']['_target_']}")
    print(f"Diffusion parameterization:  {args['diff_params']['_target_']}")
    print(f"Experiment:              {args['exp']['exp_name']}")
    print(f"Sampler:                 {args['tester']['sampler']['_target_']}")
    print(f"Checkpoint:              {args['tester']['checkpoint']}")
    print(f"Ranks:                   {describe()}")
    print()

    checkpoint = args["tester"]["checkpoint"]
    if checkpoint not in (None, "None"):
        path = os.path.join(dirname, checkpoint)
        if not os.path.exists(path):
            path = os.path.join(args["model_dir"], checkpoint)
        tester.load_checkpoint(path)
    else:
        print("trying to load latest checkpoint")
        tester.load_latest_checkpoint()

    tester.do_test()


def main(argv=None):
    from buddy_tpu_torch.config import compose, parse_cli
    from buddy_tpu_torch.parallel import init_distributed
    distributed = init_distributed()
    try:
        config_name, overrides, device = parse_cli(argv if argv is not None else sys.argv[1:])
        _main(compose(config_name, overrides), device=device)
    finally:
        if distributed:
            import torch.distributed as dist
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
