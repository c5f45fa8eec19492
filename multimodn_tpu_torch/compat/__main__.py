"""``python -m multimodn_tpu_torch.compat script.py [--device cpu] -- args``
(``compat.main``)."""
from multimodn_tpu_torch.compat import main

if __name__ == "__main__":
    main()
