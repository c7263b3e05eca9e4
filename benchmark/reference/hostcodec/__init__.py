"""A frozen copy of avrecode_tpu_torch's pure-Python host codec (codec.py,
h264/, models/h264_model.py, ops/{cabac,rangecoder,_mix_tables,_tables_data},
utils/ demuxers and container), kept here unchanged so that a change to the
program never moves the reference it is held to.  codec.compress(data,
scope="gop", substream_bins=B) is the container the program's lane path has
to produce byte for byte."""
