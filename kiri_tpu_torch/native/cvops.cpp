// The classic-CV detector's pixel operations, written to give OpenCV 5.0's
// exact output without OpenCV:
//
//   * MSER on an 8-bit grey image (the component-tree algorithm of OpenCV's
//     features2d/src/mser.cpp: the same regions, in the same order, with
//     each region's pixels in the order OpenCV links them), with each
//     region's bounding box, polygon area of its pixel list and convex-hull
//     area (cv2.boundingRect, cv2.contourArea, cv2.convexHull);
//   * connected components with stats, 8-connectivity, labels numbered as
//     OpenCV's block-based labelling numbers them (by the first 2x2 block of
//     the raster of blocks that holds a pixel of the component), no cap;
//   * Canny (L1 magnitude of 3x3 Sobel, BORDER_REPLICATE, OpenCV's
//     fixed-point tan(22.5) sector test, hysteresis);
//   * the bounding rectangles of findContours(RETR_EXTERNAL), in OpenCV's
//     order (reverse raster order of each outer border's first pixel).
//
// C ABI for ctypes (kiri_tpu_torch/native/cvops.py).
// Build: g++ -O3 -ffp-contract=off -shared -fPIC -o libkiri_cvops.so cvops.cpp

#include <algorithm>
#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// MSER (grey). Pixels are indices into a w*h buffer whose one-pixel frame is
// marked visited, so no region ever holds a frame pixel.
// ---------------------------------------------------------------------------
constexpr int DIR_SHIFT = 29;
constexpr int NEXT_MASK = (1 << DIR_SHIFT) - 1;

struct MserParams {
    int delta, min_area, max_area;
    float max_variation;
    double min_diversity;
};

struct Region {  // one captured region: its pixel list and bounds
    int head, size;
    int xmin, ymin, xmax, ymax;
};

struct WParams {
    MserParams p;
    std::vector<Region>* out;
    std::vector<int>* pts;  // x, y pairs of every region, in capture order
    int* pix;
    int step;
};

inline int get_next(int v) { return v & NEXT_MASK; }
inline void set_next(int& v, int next) { v = (v & ~NEXT_MASK) | next; }
inline int get_dir(int v) { return (int)((unsigned)v >> DIR_SHIFT); }
inline bool visited(int v) { return (v & ~NEXT_MASK) != 0; }

struct CompHistory {
    CompHistory* child_ = nullptr;
    CompHistory* parent_ = nullptr;
    CompHistory* next_ = nullptr;
    int val = 0;
    int size = 0;
    float var = -1.f;
    int head = 0;
    bool checked = false;

    void updateTree(WParams& wp, CompHistory** _h0, CompHistory** _h1,
                    bool final_) {
        if (var >= 0.f) return;
        int delta = wp.p.delta;
        CompHistory *h0_ = nullptr, *h1_ = nullptr;
        CompHistory* c = child_;
        if (size >= wp.p.min_area) {
            for (; c != nullptr; c = c->next_) {
                if (c->var < 0.f)
                    c->updateTree(wp, c == child_ ? &h0_ : nullptr,
                                  c == child_ ? &h1_ : nullptr, final_);
                if (c->var < 0.f) return;
            }
        }
        CompHistory* h0 = this;
        CompHistory* h1 = h1_ && h1_->size > size ? h1_ : this;
        if (h0_) {
            for (h0 = h0_; h0 != this && h0->val < val - delta;
                 h0 = h0->parent_) {
            }
        } else {
            for (; h0->child_ && h0->child_->val >= val - delta;
                 h0 = h0->child_) {
            }
        }
        for (; h1->parent_ && h1->parent_->val <= val + delta;
             h1 = h1->parent_) {
        }
        if (_h0) *_h0 = h0;
        if (_h1) *_h1 = h1;
        if (!final_ && !h1->parent_ && h1->val < val + delta) return;
        var = (float)(h1->size - h0->size) / size;
        for (c = child_; c != nullptr; c = c->next_) c->checkAndCapture(wp);
        if (final_ && !parent_) checkAndCapture(wp);
    }

    void checkAndCapture(WParams& wp) {
        if (checked) return;
        checked = true;
        if (size < wp.p.min_area || size > wp.p.max_area || var < 0.f ||
            var > wp.p.max_variation || var < wp.p.min_diversity)
            return;
        for (CompHistory* c = child_; c != nullptr; c = c->next_)
            if (c->var >= 0.f && var > c->var) return;
        if (var > 0.f && parent_ && parent_->var >= 0.f && var >= parent_->var)
            return;
        Region r{(int)(wp.pts->size() / 2), size, INT_MAX, INT_MAX, INT_MIN,
                 INT_MIN};
        int pix = head;
        for (int j = 0; j < size; j++, pix = get_next(wp.pix[pix])) {
            int y = pix / wp.step;
            int x = pix - y * wp.step;
            r.xmin = std::min(r.xmin, x);
            r.xmax = std::max(r.xmax, x);
            r.ymin = std::min(r.ymin, y);
            r.ymax = std::max(r.ymax, y);
            wp.pts->push_back(x);
            wp.pts->push_back(y);
        }
        wp.out->push_back(r);
    }
};

struct ConnectedComp {
    int head = 0, tail = 0;
    CompHistory* history = nullptr;
    int gray_level = 0;
    int size = 0;

    void init(int gray) {
        head = tail = 0;
        history = nullptr;
        size = 0;
        gray_level = gray;
    }

    void growHistory(CompHistory*& hptr, WParams& wp, int new_gray_level,
                     bool final_) {
        if (new_gray_level < gray_level) new_gray_level = gray_level;
        CompHistory* h;
        if (history && history->val == gray_level) {
            h = history;
        } else {
            h = hptr++;
            h->parent_ = nullptr;
            h->child_ = history;
            h->next_ = nullptr;
            if (history) history->parent_ = h;
        }
        h->val = gray_level;
        h->size = size;
        h->head = head;
        h->var = FLT_MAX;
        h->checked = true;
        if (h->size >= wp.p.min_area) {
            h->var = -1.f;
            h->checked = false;
        }
        gray_level = new_gray_level;
        history = h;
        if (history && history->val != gray_level)
            history->updateTree(wp, nullptr, nullptr, final_);
    }

    void merge(ConnectedComp* comp1, ConnectedComp* comp2, CompHistory*& hptr,
               WParams& wp) {
        if (comp1->gray_level < comp2->gray_level) std::swap(comp1, comp2);
        int gl = comp1->gray_level;
        comp1->growHistory(hptr, wp, gl, false);
        comp2->growHistory(hptr, wp, gl, false);
        if (comp1->size == 0) {
            head = comp2->head;
            tail = comp2->tail;
        } else {
            head = comp1->head;
            set_next(wp.pix[comp1->tail], comp2->head);
            tail = comp2->tail;
        }
        size = comp1->size + comp2->size;
        history = comp1->history;
        CompHistory* h1 = history->child_;
        CompHistory* h2 = comp2->history;
        if (h1 && h1->size > h2->size) {
            if (h2->size >= wp.p.min_area) {
                h2->next_ = h1->next_;
                h1->next_ = h2;
                h2->parent_ = history;
            }
        } else {
            history->child_ = h2;
            h2->parent_ = history;
            if (h1 && h1->size >= wp.p.min_area) h2->next_ = h1;
        }
    }
};

void mser_pass(const uint8_t* img, int w, int h, std::vector<int>& pix,
               std::vector<int>& heapbuf, std::vector<CompHistory>& histbuf,
               const int* level_size, int mask, WParams& wp) {
    CompHistory* histptr = histbuf.data();
    int step = w;
    int* ptr0 = pix.data();
    int ptr = step + 1;
    int* heap[256];
    ConnectedComp comp[257];
    ConnectedComp* comptr = &comp[0];
    wp.pix = ptr0;
    wp.step = step;

    heap[0] = heapbuf.data();
    heap[0][0] = 0;
    for (int i = 1; i < 256; i++) {
        heap[i] = heap[i - 1] + level_size[i - 1] + 1;
        heap[i][0] = 0;
    }
    comptr->gray_level = 256;
    comptr++;
    comptr->gray_level = img[ptr] ^ mask;
    ptr0[ptr] = (ptr0[ptr] & NEXT_MASK) | (1 << DIR_SHIFT);
    const int dir[] = {0, 1, step, -1, -step};
    for (;;) {
        int curr_gray = img[ptr] ^ mask;
        int nbr_idx = get_dir(ptr0[ptr]);
        for (; nbr_idx <= 4; nbr_idx++) {
            int nbr = ptr + dir[nbr_idx];
            if (!visited(ptr0[nbr])) {
                ptr0[nbr] = 1 << DIR_SHIFT;
                int nbr_gray = img[nbr] ^ mask;
                if (nbr_gray < curr_gray) {
                    *(++heap[curr_gray]) = ptr;
                    ptr0[ptr] = (nbr_idx + 1) << DIR_SHIFT;
                    ptr = nbr;
                    comptr++;
                    comptr->init(nbr_gray);
                    curr_gray = nbr_gray;
                    nbr_idx = 0;
                    continue;
                }
                *(++heap[nbr_gray]) = nbr;
            }
        }
        ptr0[ptr] = nbr_idx << DIR_SHIFT;
        int ptrofs = ptr;
        if (comptr->tail)
            set_next(ptr0[comptr->tail], ptrofs);
        else
            comptr->head = ptrofs;
        comptr->tail = ptrofs;
        comptr->size++;

        if (*heap[curr_gray]) {
            ptr = *heap[curr_gray];
            heap[curr_gray]--;
        } else {
            for (curr_gray++; curr_gray < 256; curr_gray++)
                if (*heap[curr_gray]) break;
            if (curr_gray >= 256) break;
            ptr = *heap[curr_gray];
            heap[curr_gray]--;
            if (curr_gray < comptr[-1].gray_level) {
                comptr->growHistory(histptr, wp, curr_gray, false);
            } else {
                comptr--;
                comptr->merge(comptr, comptr + 1, histptr, wp);
            }
        }
    }
    for (; comptr->gray_level != 256; comptr--)
        comptr->growHistory(histptr, wp, 256, true);
}

// cv2.contourArea of a closed polygon of integer points (non-oriented).
double polygon_area(const int* xy, int n) {
    if (n < 3) return 0.0;
    double a00 = 0.0;
    double px = xy[2 * (n - 1)], py = xy[2 * (n - 1) + 1];
    for (int i = 0; i < n; i++) {
        double x = xy[2 * i], y = xy[2 * i + 1];
        a00 += px * y - py * x;
        px = x;
        py = y;
    }
    return std::fabs(a00 * 0.5);
}

// Area of the convex hull of integer points (monotone chain; the hull's
// area does not depend on the algorithm that finds its vertices).
double hull_area(const int* xy, int n, std::vector<int64_t>& tmp) {
    if (n < 3) return 0.0;
    tmp.resize(n);
    for (int i = 0; i < n; i++)
        tmp[i] = ((int64_t)xy[2 * i] << 32) | (uint32_t)xy[2 * i + 1];
    std::sort(tmp.begin(), tmp.end());
    tmp.erase(std::unique(tmp.begin(), tmp.end()), tmp.end());
    int m = (int)tmp.size();
    if (m < 3) return 0.0;
    auto X = [&](int64_t v) { return (int64_t)(v >> 32); };
    auto Y = [&](int64_t v) { return (int64_t)(int32_t)(uint32_t)v; };
    std::vector<int64_t> hull(2 * m);
    int k = 0;
    auto cross = [&](int64_t o, int64_t a, int64_t b) {
        return (X(a) - X(o)) * (Y(b) - Y(o)) - (Y(a) - Y(o)) * (X(b) - X(o));
    };
    for (int i = 0; i < m; i++) {
        while (k >= 2 && cross(hull[k - 2], hull[k - 1], tmp[i]) <= 0) k--;
        hull[k++] = tmp[i];
    }
    for (int i = m - 2, t = k + 1; i >= 0; i--) {
        while (k >= t && cross(hull[k - 2], hull[k - 1], tmp[i]) <= 0) k--;
        hull[k++] = tmp[i];
    }
    k--;
    int64_t a2 = 0;
    for (int i = 0; i < k; i++) {
        int j = (i + 1) % k;
        a2 += X(hull[i]) * Y(hull[j]) - Y(hull[i]) * X(hull[j]);
    }
    return std::fabs((double)a2 * 0.5);
}

struct MserResult {
    std::vector<Region> regions;
    std::vector<int> pts;
};

MserResult* g_mser = nullptr;

// ---------------------------------------------------------------------------
// Union-find over provisional labels.
// ---------------------------------------------------------------------------
inline int uf_find(std::vector<int>& parent, int x) {
    while (parent[x] != x) {
        parent[x] = parent[parent[x]];
        x = parent[x];
    }
    return x;
}

inline int uf_union(std::vector<int>& parent, int a, int b) {
    a = uf_find(parent, a);
    b = uf_find(parent, b);
    if (a == b) return a;
    if (a < b) {
        parent[b] = a;
        return a;
    }
    parent[a] = b;
    return b;
}

// 8-connected raster labelling of nonzero pixels: provisional labels in
// `lab` (0 = background) and their roots resolved; returns the count of
// provisional labels + 1 (the parent table's size).
int label8(const uint8_t* img, int h, int w, std::vector<int>& lab,
           std::vector<int>& parent) {
    lab.assign((size_t)h * w, 0);
    parent.assign(1, 0);
    for (int y = 0; y < h; ++y) {
        const uint8_t* row = img + (size_t)y * w;
        int* lr = lab.data() + (size_t)y * w;
        const int* up = y ? lr - w : nullptr;
        for (int x = 0; x < w; ++x) {
            if (!row[x]) continue;
            int l = 0;
            auto take = [&](int o) {
                if (!o) return;
                l = l ? uf_union(parent, l, o) : uf_find(parent, o);
            };
            if (x) take(lr[x - 1]);
            if (up) {
                if (x) take(up[x - 1]);
                take(up[x]);
                if (x + 1 < w) take(up[x + 1]);
            }
            if (!l) {
                l = (int)parent.size();
                parent.push_back(l);
            }
            lr[x] = l;
        }
    }
    return (int)parent.size();
}

inline int reflect101(int i, int n) {
    if (n == 1) return 0;
    while (i < 0 || i >= n) i = i < 0 ? -i : 2 * (n - 1) - i;
    return i;
}

template <bool HW>
__attribute__((always_inline)) inline float fma32(float a, float b, float c) {
    if (HW) return __builtin_fmaf(a, b, c);
    return std::fmaf(a, b, c);
}

inline uint8_t round_u8(float v) {  // saturate_cast<uchar>(float)
    int r = (int)std::nearbyint(v);
    return (uint8_t)std::min(std::max(r, 0), 255);
}

}  // namespace

extern "C" {

// MSER of both polarities' passes on `img` [h, w] (as cv2's detectRegions
// on a CV_8U image). Returns the number of regions; their data stays
// inside the library until mser_fetch.
int mser_detect(const uint8_t* img, int h, int w, int delta, int min_area,
                int max_area, float max_variation, double min_diversity) {
    if (h < 3 || w < 3) return -1;
    delete g_mser;
    g_mser = new MserResult();
    std::vector<int> pix((size_t)w * h, 0);
    std::vector<int> heapbuf((size_t)w * h + 256);
    std::vector<CompHistory> histbuf((size_t)w * h);
    int level_size[256] = {0};
    const int border = 5 << DIR_SHIFT;
    for (int j = 0; j < w; j++) pix[j] = pix[j + (size_t)(h - 1) * w] = border;
    for (int i = 1; i < h - 1; i++) {
        pix[(size_t)i * w] = pix[(size_t)i * w + w - 1] = border;
        for (int j = 1; j < w - 1; j++) level_size[img[(size_t)i * w + j]]++;
    }
    WParams wp;
    wp.p = MserParams{delta, min_area, max_area, max_variation,
                      min_diversity};
    wp.out = &g_mser->regions;
    wp.pts = &g_mser->pts;
    mser_pass(img, w, h, pix, heapbuf, histbuf, level_size, 0, wp);
    for (int i = 0; i < 128; i++) std::swap(level_size[i], level_size[255 - i]);
    for (int i = 1; i < h - 1; i++)
        for (int j = 1; j < w - 1; j++) pix[(size_t)i * w + j] = 0;
    std::fill(histbuf.begin(), histbuf.end(), CompHistory());
    mser_pass(img, w, h, pix, heapbuf, histbuf, level_size, 255, wp);
    return (int)g_mser->regions.size();
}

// The number of pixels over all regions of the last mser_detect.
long mser_points_total() { return g_mser ? (long)g_mser->pts.size() / 2 : 0; }

// Per region of the last mser_detect: rects [n, 4] (x, y, w, h), sizes [n],
// area and hull_area [n] (cv2.contourArea of the pixel list and of its
// convexHull); with `points` non-null also every region's (x, y) pixels,
// concatenated in region order (sum(sizes) rows). Frees the result.
void mser_fetch(int32_t* rects, int32_t* sizes, double* area,
                double* hull, int32_t* points) {
    if (!g_mser) return;
    std::vector<int64_t> tmp;
    const int* pts = g_mser->pts.data();
    for (size_t i = 0; i < g_mser->regions.size(); i++) {
        const Region& r = g_mser->regions[i];
        rects[4 * i] = r.xmin;
        rects[4 * i + 1] = r.ymin;
        rects[4 * i + 2] = r.xmax - r.xmin + 1;
        rects[4 * i + 3] = r.ymax - r.ymin + 1;
        sizes[i] = r.size;
        const int* p = pts + 2 * (size_t)r.head;
        area[i] = polygon_area(p, r.size);
        hull[i] = hull_area(p, r.size, tmp);
    }
    if (points)
        std::memcpy(points, pts, sizeof(int32_t) * g_mser->pts.size());
    delete g_mser;
    g_mser = nullptr;
}

// cv2.connectedComponentsWithStats(img, connectivity=8) without a cap:
// labels [h, w] int32 and stats [n, 5] (x, y, w, h, area; row 0 the
// background). `stats` holds room for (h+1)/2 * (w+1)/2 + 1 rows. Returns
// n (the background included).
int cc_stats8(const uint8_t* img, int h, int w, int32_t* labels,
              int32_t* stats) {
    std::vector<int> lab, parent;
    int np = label8(img, h, w, lab, parent);
    // Order components by their first 2x2 block in block-raster order.
    int bw = (w + 1) / 2;
    std::vector<int64_t> first(np, INT64_MAX);
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
            int l = lab[(size_t)y * w + x];
            if (!l) continue;
            int r = uf_find(parent, l);
            int64_t b = (int64_t)(y / 2) * bw + x / 2;
            if (b < first[r]) first[r] = b;
        }
    std::vector<int> roots;
    for (int l = 1; l < np; ++l)
        if (parent[l] == l) roots.push_back(l);
    std::sort(roots.begin(), roots.end(),
              [&](int a, int b) { return first[a] < first[b]; });
    std::vector<int> final_of(np, 0);
    for (size_t i = 0; i < roots.size(); ++i) final_of[roots[i]] = (int)i + 1;
    int n = (int)roots.size() + 1;
    for (int i = 0; i < n; ++i) {
        stats[5 * i] = w;
        stats[5 * i + 1] = h;
        stats[5 * i + 2] = -1;  // x max, turned into a width below
        stats[5 * i + 3] = -1;
        stats[5 * i + 4] = 0;
    }
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
            int l = lab[(size_t)y * w + x];
            int f = l ? final_of[uf_find(parent, l)] : 0;
            labels[(size_t)y * w + x] = f;
            int32_t* s = stats + 5 * f;
            if (x < s[0]) s[0] = x;
            if (y < s[1]) s[1] = y;
            if (x > s[2]) s[2] = x;
            if (y > s[3]) s[3] = y;
            s[4]++;
        }
    for (int i = 0; i < n; ++i) {
        int32_t* s = stats + 5 * i;
        if (s[4] == 0) {  // no background pixel: OpenCV's empty row
            s[0] = -1;
            s[1] = INT_MAX;
            s[2] = s[3] = 0;
            continue;
        }
        s[2] = s[2] - s[0] + 1;
        s[3] = s[3] - s[1] + 1;
    }
    return n;
}

// cv2.createCLAHE(clip, (tiles_x, tiles_y)).apply(img) for 8-bit images.
void clahe(const uint8_t* src, int h, int w, double clip, int tiles_x,
           int tiles_y, uint8_t* dst) {
    const int hist_size = 256;
    int ew = w, eh = h;  // the image the LUTs are taken from
    if (w % tiles_x || h % tiles_y) {
        ew = w + tiles_x - w % tiles_x;
        eh = h + tiles_y - h % tiles_y;
    }
    int tw = ew / tiles_x, th = eh / tiles_y;
    int total = tw * th;
    float lut_scale = (float)(hist_size - 1) / total;
    int clip_limit = 0;
    if (clip > 0.0) {
        clip_limit = (int)(clip * total / hist_size);
        clip_limit = std::max(clip_limit, 1);
    }
    std::vector<uint8_t> lut((size_t)tiles_x * tiles_y * hist_size);
    std::vector<int> xs(tw);
    for (int ty = 0; ty < tiles_y; ++ty)
        for (int tx = 0; tx < tiles_x; ++tx) {
            int hist[256] = {0};
            for (int i = 0; i < tw; ++i) xs[i] = reflect101(tx * tw + i, w);
            for (int j = 0; j < th; ++j) {
                const uint8_t* row = src + (size_t)reflect101(ty * th + j, h) * w;
                for (int i = 0; i < tw; ++i) hist[row[xs[i]]]++;
            }
            if (clip_limit > 0) {
                int clipped = 0;
                for (int i = 0; i < hist_size; ++i)
                    if (hist[i] > clip_limit) {
                        clipped += hist[i] - clip_limit;
                        hist[i] = clip_limit;
                    }
                int batch = clipped / hist_size;
                int residual = clipped - batch * hist_size;
                for (int i = 0; i < hist_size; ++i) hist[i] += batch;
                if (residual != 0) {
                    int step = std::max(hist_size / residual, 1);
                    for (int i = 0; i < hist_size && residual > 0;
                         i += step, residual--)
                        hist[i]++;
                }
            }
            uint8_t* t = lut.data() + (size_t)(ty * tiles_x + tx) * hist_size;
            int sum = 0;
            for (int i = 0; i < hist_size; ++i) {
                sum += hist[i];
                t[i] = round_u8((float)sum * lut_scale);
            }
        }
    float inv_tw = 1.0f / tw, inv_th = 1.0f / th;
    std::vector<int> ind1(w), ind2(w);
    std::vector<float> xa(w), xa1(w);
    for (int x = 0; x < w; ++x) {
        float txf = x * inv_tw - 0.5f;
        int tx1 = (int)std::floor(txf);
        int tx2 = tx1 + 1;
        xa[x] = txf - tx1;
        xa1[x] = 1.0f - xa[x];
        tx1 = std::max(tx1, 0);
        tx2 = std::min(tx2, tiles_x - 1);
        ind1[x] = tx1 * hist_size;
        ind2[x] = tx2 * hist_size;
    }
    for (int y = 0; y < h; ++y) {
        float tyf = y * inv_th - 0.5f;
        int ty1 = (int)std::floor(tyf);
        int ty2 = ty1 + 1;
        float ya = tyf - ty1, ya1 = 1.0f - ya;
        ty1 = std::max(ty1, 0);
        ty2 = std::min(ty2, tiles_y - 1);
        const uint8_t* p1 = lut.data() + (size_t)ty1 * tiles_x * hist_size;
        const uint8_t* p2 = lut.data() + (size_t)ty2 * tiles_x * hist_size;
        const uint8_t* srow = src + (size_t)y * w;
        uint8_t* drow = dst + (size_t)y * w;
        for (int x = 0; x < w; ++x) {
            int v = srow[x];
            float res = (p1[ind1[x] + v] * xa1[x] + p1[ind2[x] + v] * xa[x]) * ya1 +
                        (p2[ind1[x] + v] * xa1[x] + p2[ind2[x] + v] * xa[x]) * ya;
            drow[x] = round_u8(res);
        }
    }
}

// The kernel of cv2.getGaussianKernel(ksize, 0, CV_32F) for an odd ksize
// above 7: OpenCV's bit-exact double kernel (sigma = 0.15 ksize + 0.35 as
// one fused multiply-add, the taps at doubled offsets, the sum taken over
// one half), cast to float.
void gaussian_kernel(int ksize, float* k) {
    double sigma = std::fma((double)ksize, 0.15, 0.35);
    double scale2 = -0.125 / (sigma * sigma);
    int half = (ksize - 1) / 2;
    std::vector<double> v(half + 1);
    double sum = 0;
    for (int i = 0, x = 1 - ksize; i < half; i++, x += 2) {
        v[i] = std::exp((double)(x * x) * scale2);
        sum += v[i];
    }
    sum = sum * 2 + 1;
    v[half] = 1;
    for (int i = 0; i <= half; i++) k[i] = k[ksize - 1 - i] = (float)(v[i] / sum);
}

// The local mean of cv2.adaptiveThreshold(ADAPTIVE_THRESH_GAUSSIAN_C,
// block ksize): the image as float32, GaussianBlur (sigma from ksize,
// BORDER_REPLICATE), rounded to u8. The blur is separable, and the float
// operations are those of OpenCV's AVX2 build: along the row a chain of
// fused multiply-adds for the columns below w/4*4 and separate multiplies
// and adds for the rest; along the column the centre tap times its weight,
// then one multiply-add a symmetric pair, fused below column w/8*8.
extern "C++" {
template <bool HW>
static void gauss_mean_impl(const uint8_t* src, int h, int w, int ksize,
                            uint8_t* dst) {
    int r = ksize / 2;
    std::vector<float> k(ksize);
    gaussian_kernel(ksize, k.data());
    std::vector<float> rows((size_t)h * w), line(w + 2 * r);
    const int row_fused = w / 4 * 4, col_fused = w / 8 * 8;
    for (int y = 0; y < h; ++y) {
        const uint8_t* s = src + (size_t)y * w;
        for (int i = 0; i < w + 2 * r; ++i)
            line[i] = s[std::min(std::max(i - r, 0), w - 1)];
        float* d = rows.data() + (size_t)y * w;
        for (int x = 0; x < w; ++x) {
            const float* l = line.data() + x;
            float acc;
            if (x < row_fused) {
                acc = 0.f;
                for (int j = 0; j < ksize; ++j) acc = fma32<HW>(l[j], k[j], acc);
            } else {
                acc = l[0] * k[0];
                for (int j = 1; j < ksize; ++j) acc = acc + l[j] * k[j];
            }
            d[x] = acc;
        }
    }
    const float* ky = k.data() + r;
    std::vector<const float*> rp(2 * r + 1);
    for (int y = 0; y < h; ++y) {
        for (int j = -r; j <= r; ++j)
            rp[j + r] = rows.data() + (size_t)std::min(std::max(y + j, 0), h - 1) * w;
        const float* const* c = rp.data() + r;
        uint8_t* d = dst + (size_t)y * w;
        for (int x = 0; x < w; ++x) {
            float acc = c[0][x] * ky[0];
            if (x < col_fused) {
                for (int j = 1; j <= r; ++j)
                    acc = fma32<HW>(c[j][x] + c[-j][x], ky[j], acc);
            } else {
                for (int j = 1; j <= r; ++j)
                    acc = acc + (c[j][x] + c[-j][x]) * ky[j];
            }
            d[x] = round_u8(acc);
        }
    }
}

}  // extern "C++"

// The fused multiply-adds are exact either way; the FMA instruction is
// only faster than the library's software fmaf.
__attribute__((target("fma"))) static void gauss_mean_fma(
    const uint8_t* src, int h, int w, int ksize, uint8_t* dst) {
    gauss_mean_impl<true>(src, h, w, ksize, dst);
}

void gauss_mean(const uint8_t* src, int h, int w, int ksize, uint8_t* dst) {
    if (__builtin_cpu_supports("fma"))
        gauss_mean_fma(src, h, w, ksize, dst);
    else
        gauss_mean_impl<false>(src, h, w, ksize, dst);
}

// cv2.Canny(img, low, high) (aperture 3, L1 gradient): 255 on edges.
void canny(const uint8_t* img, int h, int w, int low, int high,
           uint8_t* dst) {
    auto at = [&](int y, int x) {
        y = std::min(std::max(y, 0), h - 1);
        x = std::min(std::max(x, 0), w - 1);
        return (int)img[(size_t)y * w + x];
    };
    // Magnitudes with a zero frame; dx, dy of the pixels themselves.
    int mw = w + 2;
    std::vector<int> mag((size_t)(h + 2) * mw, 0);
    std::vector<int> dxv((size_t)h * w), dyv((size_t)h * w);
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
            int dx = (at(y - 1, x + 1) + 2 * at(y, x + 1) + at(y + 1, x + 1)) -
                     (at(y - 1, x - 1) + 2 * at(y, x - 1) + at(y + 1, x - 1));
            int dy = (at(y + 1, x - 1) + 2 * at(y + 1, x) + at(y + 1, x + 1)) -
                     (at(y - 1, x - 1) + 2 * at(y - 1, x) + at(y - 1, x + 1));
            dxv[(size_t)y * w + x] = dx;
            dyv[(size_t)y * w + x] = dy;
            mag[(size_t)(y + 1) * mw + x + 1] = std::abs(dx) + std::abs(dy);
        }
    // 1: not an edge, 0: weak candidate, 2: edge.
    std::vector<uint8_t> map((size_t)(h + 2) * mw, 1);
    std::vector<size_t> stack;
    constexpr int SHIFT = 15;
    const int TG22 = (int)(0.4142135623730950488016887242097 * (1 << SHIFT) +
                           0.5);
    for (int y = 0; y < h; ++y) {
        const int* mp = mag.data() + (size_t)y * mw + 1;  // row y-1
        const int* mc = mp + mw;
        const int* mn = mc + mw;
        for (int x = 0; x < w; ++x) {
            int m = mc[x];
            if (m <= low) continue;
            int xs = dxv[(size_t)y * w + x], ys = dyv[(size_t)y * w + x];
            int ax = std::abs(xs), ay = std::abs(ys) << SHIFT;
            int tg22x = ax * TG22;
            bool keep;
            if (ay < tg22x) {
                keep = m > mc[x - 1] && m >= mc[x + 1];
            } else {
                int tg67x = tg22x + (ax << (SHIFT + 1));
                if (ay > tg67x) {
                    keep = m > mp[x] && m >= mn[x];
                } else {
                    int s = (xs ^ ys) < 0 ? -1 : 1;
                    keep = m > mp[x - s] && m > mn[x + s];
                }
            }
            if (!keep) continue;
            size_t k = (size_t)(y + 1) * mw + x + 1;
            if (m > high) {
                map[k] = 2;
                stack.push_back(k);
            } else {
                map[k] = 0;
            }
        }
    }
    const long offs[8] = {-mw - 1, -mw, -mw + 1, -1, 1, mw - 1, mw, mw + 1};
    while (!stack.empty()) {
        size_t k = stack.back();
        stack.pop_back();
        for (long o : offs) {
            size_t n = (size_t)((long)k + o);
            if (map[n] == 0) {
                map[n] = 2;
                stack.push_back(n);
            }
        }
    }
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
            dst[(size_t)y * w + x] =
                map[(size_t)(y + 1) * mw + x + 1] == 2 ? 255 : 0;
}

// The bounding rectangles (x, y, w, h) of the contours that
// cv2.findContours(img, RETR_EXTERNAL, ...) returns, in its order: one per
// 8-connected component of nonzero pixels that lies in the background
// around the image (not in a hole of another component), latest first
// pixel in raster order first. Returns their count; `rects` holds room for
// (h+1)/2 * (w+1)/2 rows.
int external_rects(const uint8_t* img, int h, int w, int32_t* rects) {
    int ph = h + 2, pw = w + 2;
    std::vector<uint8_t> pad((size_t)ph * pw, 0);
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
            pad[(size_t)(y + 1) * pw + x + 1] = img[(size_t)y * w + x] != 0;
    std::vector<int> lab, parent;
    label8(pad.data(), ph, pw, lab, parent);
    // 4-connected background components.
    std::vector<int> bg((size_t)ph * pw, 0), bparent(1, 0);
    for (int y = 0; y < ph; ++y)
        for (int x = 0; x < pw; ++x) {
            size_t k = (size_t)y * pw + x;
            if (pad[k]) continue;
            int l = 0;
            if (x && !pad[k - 1]) l = uf_find(bparent, bg[k - 1]);
            if (y && !pad[k - pw])
                l = l ? uf_union(bparent, l, bg[k - pw])
                      : uf_find(bparent, bg[k - pw]);
            if (!l) {
                l = (int)bparent.size();
                bparent.push_back(l);
            }
            bg[k] = l;
        }
    int outer = uf_find(bparent, bg[0]);
    int np = (int)parent.size();
    std::vector<int> x0(np, INT_MAX), y0(np, INT_MAX), x1(np, -1), y1(np, -1);
    std::vector<int> first_order;
    std::vector<char> seen(np, 0), external(np, 0);
    for (int y = 1; y <= h; ++y)
        for (int x = 1; x <= w; ++x) {
            size_t k = (size_t)y * pw + x;
            if (!lab[k]) continue;
            int r = uf_find(parent, lab[k]);
            if (!seen[r]) {
                seen[r] = 1;
                first_order.push_back(r);
                external[r] = uf_find(bparent, bg[k - 1]) == outer;
            }
            x0[r] = std::min(x0[r], x - 1);
            y0[r] = std::min(y0[r], y - 1);
            x1[r] = std::max(x1[r], x - 1);
            y1[r] = std::max(y1[r], y - 1);
        }
    int n = 0;
    for (auto it = first_order.rbegin(); it != first_order.rend(); ++it) {
        int r = *it;
        if (!external[r]) continue;
        rects[4 * n] = x0[r];
        rects[4 * n + 1] = y0[r];
        rects[4 * n + 2] = x1[r] - x0[r] + 1;
        rects[4 * n + 3] = y1[r] - y0[r] + 1;
        n++;
    }
    return n;
}

// PNG rows with their filter byte (h rows of 1 + stride bytes) -> the
// unfiltered rows (h x stride); bpp is the bytes a pixel (at least 1).
// Returns 0, or -1 on an unknown filter type.
int png_unfilter(const uint8_t* raw, int h, int stride, int bpp,
                 uint8_t* out) {
    std::vector<uint8_t> zero(stride, 0);
    for (int y = 0; y < h; ++y) {
        const uint8_t* line = raw + (size_t)y * (stride + 1);
        int ftype = line[0];
        line++;
        uint8_t* cur = out + (size_t)y * stride;
        const uint8_t* prev = y ? cur - stride : zero.data();
        for (int x = 0; x < stride; ++x) {
            int a = x >= bpp ? cur[x - bpp] : 0;
            int b = prev[x];
            int c = x >= bpp ? prev[x - bpp] : 0;
            int pred;
            switch (ftype) {
                case 0: pred = 0; break;
                case 1: pred = a; break;
                case 2: pred = b; break;
                case 3: pred = (a + b) >> 1; break;
                case 4: {
                    int p = a + b - c;
                    int pa = std::abs(p - a), pb = std::abs(p - b),
                        pc = std::abs(p - c);
                    pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    break;
                }
                default: return -1;
            }
            cur[x] = (uint8_t)(line[x] + pred);
        }
    }
    return 0;
}

}  // extern "C"
