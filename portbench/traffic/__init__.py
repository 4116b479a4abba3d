"""Traffic drivers, one module a kind: a cell's `traffic.kind` names its
module here, which defines `Driver` (a portbench.driver.Driver)."""
