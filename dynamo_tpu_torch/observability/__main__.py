import sys

from .report import main

sys.exit(main())
