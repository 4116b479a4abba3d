"""`python -m cometbft_tpu_torch <cmd>`: the operator CLI (cmd/cli.py)."""
from cometbft_tpu_torch.cmd.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
