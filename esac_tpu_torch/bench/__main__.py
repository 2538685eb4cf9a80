"""``python -m esac_tpu_torch.bench [MODE] [--cpu]`` (see the package)."""

import sys

from esac_tpu_torch.bench import main

if __name__ == "__main__":
    sys.exit(main())
