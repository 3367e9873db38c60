"""`ds_elastic` (port of deepspeed_tpu/elasticity/__main__.py): given a
ds_config JSON, print the final batch size, the valid device counts and,
with a world size, the micro batch.

Run as `python -m deepspeed_tpu_torch.elasticity -c ds_config.json [-w N]`."""

import argparse
import json

from deepspeed_tpu_torch.elasticity import compute_elastic_config
from deepspeed_tpu_torch.version import __version__


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True,
                        help="DeepSpeed config json")
    parser.add_argument("-w", "--world-size", type=int, default=0,
                        help="Intended/current world size")
    args = parser.parse_args()

    with open(args.config) as fd:
        ds_config = json.load(fd)

    if args.world_size > 0:
        final_batch_size, valid_gpus, micro_batch_size = \
            compute_elastic_config(ds_config=ds_config,
                                   target_deepspeed_version=__version__,
                                   world_size=args.world_size)
        print(f"micro_batch_size .... {micro_batch_size}")
    else:
        final_batch_size, valid_gpus = compute_elastic_config(
            ds_config=ds_config, target_deepspeed_version=__version__)
    print(f"final_batch_size .... {final_batch_size}")
    print(f"valid_gpus .......... {valid_gpus}")


if __name__ == "__main__":
    main()
