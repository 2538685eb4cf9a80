"""The port's entry scripts: the three training stages and evaluation, and
the original-ESAC checkpoint converter.  Each module has ``main(argv=None)
-> int`` and runs as ``python -m esac_tpu_torch.scripts.<name>``:

    train_expert.py × M  →  train_gating.py  →  train_esac.py  →  test_esac.py
"""
