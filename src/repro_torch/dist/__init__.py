"""Distribution helpers of the port. One device serves and trains
today: the degraded-mesh shape math (``elastic.degrade_mesh``), which the
serving fleet's scale-down uses, and the blockwise int8 codec
(``compression``), which the 8-bit optimizer keeps its moments in."""
