"""The GTA paper's own evaluation setting (Table 1): the 4-lane GTA
instance beside the area-parity baselines of ``core.simulator``.  Used
by ``launch.paper_tables``; it describes an accelerator, not a network,
so the architecture registry does not list it."""
from repro_torch.core.scheduler import GTAConfig

GTA_4LANE = GTAConfig(lanes=4)
