"""Training entry point, CLI-compatible with the JAX package's ``train.py``:

    python -m buddy_tpu_torch.training --config-name=conf_VCTK.yaml \
        dset.train.path=<dir of speaker dirs of WAVs> exp.max_iters=<n>

Builds the training set and its loader, the network (random weights from
``exp.seed``), the EDM parameterisation, the in-training tester (which
samples as trained: ``tester.sampling_params.same_as_training``) and the
trainer, and runs the training loop.  Runs on the first CUDA device;
``device=cpu`` asks for the CPU (the plain versions of the kernels).  A
relative ``model_dir`` is taken from the directory that holds the package;
it is made if missing.  On several cards, one rank a card (``exp.mesh``):

    torchrun --standalone --nproc_per_node=<cards> -m buddy_tpu_torch.training ...
"""

from __future__ import annotations

import os
import sys


def _main(args, device=None):
    from buddy_tpu_torch.config import instantiate
    from buddy_tpu_torch.data.loader import make_train_loader
    from buddy_tpu_torch.device import resolve_device
    from buddy_tpu_torch.models import NetworkBundle
    from buddy_tpu_torch.parallel.mesh import describe
    from buddy_tpu_torch.testing.tester import Tester

    device = resolve_device(device)
    dirname = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args["model_dir"] = os.path.join(dirname, str(args["model_dir"]))
    os.makedirs(args["model_dir"], exist_ok=True)
    args["exp"]["model_dir"] = args["model_dir"]

    train_set = instantiate(args["dset"]["train"])
    train_loader = make_train_loader(train_set, batch_size=int(args["exp"]["batch_size"]),
                                     num_workers=int(args["exp"]["num_workers"]),
                                     seed=int(args["exp"]["seed"]))
    try:
        test_set = instantiate(args["dset"]["test"])
    except (OSError, AssertionError) as e:      # a missing or short test directory
        print(f"test set unavailable ({e}); continuing without")
        test_set = None

    diff_params = instantiate(args["diff_params"])
    network = NetworkBundle(instantiate(args["network"], device=device,
                                        seed=int(args["exp"]["seed"])))
    args["tester"]["sampling_params"]["same_as_training"] = True
    tester = Tester(args, network, diff_params, test_set=test_set, device=device,
                    in_training=True)
    trainer = instantiate(args["exp"]["trainer"], args, train_loader, network, diff_params,
                          tester, device=device)

    print()
    print("Training options:")
    print()
    print(f"Output directory:        {args['model_dir']}")
    print(f"Network architecture:    {args['network']['_target_']}")
    print(f"Dataset:    {args['dset']['train']['_target_']}")
    print(f"Diffusion parameterization:  {args['diff_params']['_target_']}")
    print(f"Batch size:              {args['exp']['batch_size']}")
    print(f"Loader:                  {type(train_loader).__name__} "
          f"({args['exp']['num_workers']} workers, seed {args['exp']['seed']})")
    print(f"Device:                  {device}")
    print(f"Ranks:                   {describe()}")
    print()

    try:
        trainer.training_loop()
    finally:
        train_loader.close()


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
