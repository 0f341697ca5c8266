"""Operations and bytes of a module call, from the shapes it is given.

The yardstick of the rooflines and of ``mfu``: a call's least time on the
card is the larger of its operations at the card's peak and its bytes at
the card's bandwidth (``peaks.py``).  Operations count the products of
dense layers, convolutions and attention (2 a multiply-add); norms and
elementwise work are left out, so the count is a floor.  Bytes count each
input read once, each weight once and each output written once, in the
activations' element size; whatever a kernel reads again or keeps between
launches is not counted.  The counts follow from the shapes a call
receives (the tokens each attention really got after merging), never from
the kernels that ran.
"""
