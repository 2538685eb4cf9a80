"""The port's entry scripts: the three training stages and evaluation, the
original-ESAC checkpoint converter and the dataset preparation scripts.
Each module has ``main(argv=None) -> int`` and runs as
``python -m esac_tpu_torch.scripts.<name>``:

    setup_{7scenes,12scenes,aachen}.py  →  train_expert.py × M  →
    train_gating.py  →  train_esac.py  →  test_esac.py
"""
