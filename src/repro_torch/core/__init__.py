"""The port's core: the torch fleet executor beside copies of the
framework-neutral planner, churn recovery and Freivalds oracle."""
