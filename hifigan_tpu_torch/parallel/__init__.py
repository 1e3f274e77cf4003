"""Time-axis helpers of the port (``hifigan_tpu/parallel``): so far the halo
streamer; the sharded generator and the device mesh are not ported yet."""
