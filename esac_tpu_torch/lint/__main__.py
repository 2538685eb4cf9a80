import sys

from esac_tpu_torch.lint.cli import main

if __name__ == "__main__":
    sys.exit(main())
