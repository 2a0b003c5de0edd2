"""Carbon-aware data movement: the planner stack of the port."""
