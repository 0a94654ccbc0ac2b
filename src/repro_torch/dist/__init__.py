"""Distribution helpers of the port. One device serves today: only the
degraded-mesh shape math (``elastic.degrade_mesh``) is here, which the
serving fleet's scale-down uses."""
