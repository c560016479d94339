"""Post-training algorithms. PyTorch port of ``ao_tpu/algorithms``: so far
``observe.py``, the calibration observers the others build on."""
