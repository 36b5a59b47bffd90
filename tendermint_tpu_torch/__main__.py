"""`python -m tendermint_tpu_torch` — the CLI binary (cmd/tendermint/main.go)."""

import sys

from .cli import main

if __name__ == "__main__":  # importing the module (a package walk) runs nothing
    sys.exit(main())
