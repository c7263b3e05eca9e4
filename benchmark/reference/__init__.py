"""The plain reference that decides a run's `correct`: the containers the
recompressor has to produce, worked out from the input files alone by a
pure-Python H.264 recompressor (hostcodec/) that imports nothing of the
program under test."""
