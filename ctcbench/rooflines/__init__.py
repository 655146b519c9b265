"""One function a kernel: the operations and bytes that the data of a
launch needs, the same whatever implements it.  Frames are live frames
(padding needs no work); each input byte is counted read once and each
output byte written once."""
