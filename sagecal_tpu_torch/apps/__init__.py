"""Apps of the port (counterpart of ``sagecal_tpu/apps``): the
fullbatch calibration driver and its command line so far."""
