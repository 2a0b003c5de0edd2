"""Time/space/overlay shifting and the joint SLA planner."""
