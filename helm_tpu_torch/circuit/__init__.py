"""Netlist front end, scheduler and level planner (the port's copies of
helm_tpu.circuit)."""
