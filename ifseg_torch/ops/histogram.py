"""Per-class area histograms for segmentation metrics.

Matches the reference's ``torch.histc(x, bins=C, min=0, max=C-1)`` usage on
integer class ids (criterions/seg_criterion.py:349-362): a bincount over
[0, C), with ``weights`` for masked accumulation.  The weights are 0 or 1, so
the fp32 sums are exact whatever order the device adds them in.
"""

import torch


def class_histogram(ids, num_classes: int, weights=None):
    """Counts of each class id in [0, num_classes) as fp32; ids outside are
    dropped."""
    ids = ids.reshape(-1)
    inside = (ids >= 0) & (ids < num_classes)
    w = inside.float()
    if weights is not None:
        w = w * weights.reshape(-1).float()
    safe = torch.where(inside, ids, torch.zeros_like(ids))
    return torch.bincount(safe, weights=w, minlength=num_classes).float()


def confusion_areas(pred, target, num_classes: int, valid=None):
    """(area_intersect, area_pred, area_label, area_union) per class.

    Intersect counts predictions that equal the target, pred/label are the
    marginal histograms, union = pred + label - intersect.  ``valid`` masks
    out padded or ignored pixels (weight 0)."""
    pred = pred.reshape(-1)
    target = target.reshape(-1)
    w = None if valid is None else valid.reshape(-1).float()
    match = (pred == target).float()
    mw = match if w is None else match * w
    area_intersect = class_histogram(pred, num_classes, weights=mw)
    area_pred = class_histogram(pred, num_classes, weights=w)
    area_label = class_histogram(target, num_classes, weights=w)
    return area_intersect, area_pred, area_label, area_pred + area_label - area_intersect
