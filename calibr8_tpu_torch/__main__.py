import sys

from calibr8_tpu_torch.cli.main import main

sys.exit(main())
