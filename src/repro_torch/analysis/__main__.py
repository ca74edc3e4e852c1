"""``python -m repro_torch.analysis src/repro_torch`` — run repro-lint,
exit nonzero on unwaived findings."""
import sys

from repro_torch.analysis.lint import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
