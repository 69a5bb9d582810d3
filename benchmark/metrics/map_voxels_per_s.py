"""1 A voxels of every map the window finished over the window's seconds
(the window holds whole maps)."""


def read(run):
    if run.kind != "predict" or not run.driver.records:
        return None
    return sum(r["voxels"] for r in run.driver.records) / run.window_s
