"""``python -m paddle_tpu_torch.distributed.launch``."""
import sys

from .main import main

if __name__ == "__main__":
    sys.exit(main())
