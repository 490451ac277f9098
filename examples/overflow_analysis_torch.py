"""Analysis-library session on the PyTorch port
(``repro_torch.overflow_analysis``): the steps of
``examples/overflow_analysis.py`` on the CUDA card, or on the CPU with
``--device cpu``.

  PYTHONPATH=src python examples/overflow_analysis_torch.py [--device cpu]
"""

import argparse

from repro_torch.overflow_analysis import main

if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
