"""Expert dispatch across frames (counterpart of ``esac_tpu/parallel``)."""
