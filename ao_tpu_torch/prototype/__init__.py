"""Prototype workflows of the port (``ao_tpu/prototype``): the MX and NVFP4
inference configs."""
