"""The self-contained interactive t-SNE viewer's script, for
``workloads.embed.export_interactive_html`` of the port.

A copy of the JAX package's ``VIEWER_JS``, character for character, so that
the port writes the same HTML for the same inputs.  Its features: the
reference Tkinter viewer's task dropdown, scatter, hover path,
cursor-centered wheel zoom, polygon selector (``p`` toggles; a double-click
closes the polygon and downloads ``inside_polygon_<task>.json``),
click-to-view from embedded base64 thumbnails, and a per-class color
picker.
"""

VIEWER_JS = """
const sel=document.getElementById('task'),cv=document.getElementById('c'),
ctx=cv.getContext('2d'),info=document.getElementById('info'),
img=document.getElementById('pv'),pvcap=document.getElementById('pvcap'),
legend=document.getElementById('legend');
const PAL=['#1f77b4','#ff7f0e','#2ca02c','#d62728','#9467bd','#8c564b',
'#e377c2','#7f7f7f','#bcbd22','#17becf'];
Object.keys(DATA).forEach(t=>{const o=document.createElement('option');
o.value=t;o.textContent=t;sel.appendChild(o);});
const colors={};  // per task: per-class editable palette
function pal(t){if(!colors[t])colors[t]=DATA[t].classes.map((_,i)=>PAL[i%PAL.length]);
return colors[t];}
let pts=[],zoom=1,cx=450,cy=450;
function buildLegend(){const d=DATA[sel.value],p=pal(sel.value);
legend.innerHTML='';d.classes.forEach((c,i)=>{
const row=document.createElement('div');
const inp=document.createElement('input');inp.type='color';inp.value=p[i];
inp.oninput=()=>{p[i]=inp.value;draw();drawPoly();};
const lab=document.createElement('span');lab.textContent=' '+c;
row.appendChild(inp);row.appendChild(lab);legend.appendChild(row);});}
function draw(){const d=DATA[sel.value],p=pal(sel.value);
ctx.clearRect(0,0,900,900);pts=[];
if(!d.xy.length)return;
const xs=d.xy.map(q=>q[0]),ys=d.xy.map(q=>q[1]);
const x0=Math.min(...xs),x1=Math.max(...xs),y0=Math.min(...ys),y1=Math.max(...ys);
d.xy.forEach((q,i)=>{let x=30+840*(q[0]-x0)/((x1-x0)||1),
y=30+840*(q[1]-y0)/((y1-y0)||1);
x=(x-cx)*zoom+450;y=(y-cy)*zoom+450;
const l=d.labels[i];
ctx.fillStyle=l>=0?p[l%p.length]:'#000';
ctx.beginPath();ctx.arc(x,y,4,0,6.3);ctx.fill();pts.push([x,y,i]);});}
cv.onwheel=e=>{e.preventDefault();const r=cv.getBoundingClientRect();
const mx=e.clientX-r.left,my=e.clientY-r.top;
// zoom centered on the cursor (reference: wheel zoom centered on last click)
cx=cx+(mx-450)/zoom;cy=cy+(my-450)/zoom;
zoom*=e.deltaY<0?1.25:0.8;zoom=Math.max(0.2,Math.min(50,zoom));
cx=cx-(mx-450)/zoom;cy=cy-(my-450)/zoom;draw();drawPoly();};
function hit(mx,my){for(const[x,y,i]of pts)
if((x-mx)**2+(y-my)**2<25)return i;return -1;}
cv.onmousemove=e=>{const r=cv.getBoundingClientRect(),
mx=e.clientX-r.left,my=e.clientY-r.top;const d=DATA[sel.value];
const i=hit(mx,my);
info.textContent=i>=0?(d.paths[i]||'')+' / '+(d.classes[d.labels[i]]||'Unknown'):'';};
let polyMode=false,poly=[];
document.addEventListener('keydown',e=>{if(e.key==='p'){polyMode=!polyMode;
poly=[];draw();info.textContent=polyMode?'polygon mode: click vertices, double-click to close':'';}});
function drawPoly(){if(!poly.length)return;ctx.strokeStyle='#d00';ctx.beginPath();
ctx.moveTo(poly[0][0],poly[0][1]);poly.slice(1).forEach(p=>ctx.lineTo(p[0],p[1]));
ctx.stroke();}
function inside(x,y){let c=false;for(let i=0,j=poly.length-1;i<poly.length;j=i++){
const[xi,yi]=poly[i],[xj,yj]=poly[j];
if((yi>y)!=(yj>y)&&x<(xj-xi)*(y-yi)/(yj-yi)+xi)c=!c;}return c;}
cv.onclick=e=>{const r=cv.getBoundingClientRect(),mx=e.clientX-r.left,my=e.clientY-r.top;
if(polyMode){poly.push([mx,my]);draw();drawPoly();return;}
const d=DATA[sel.value],i=hit(mx,my);
if(i<0)return;
const path=d.paths[i]||'';
// click-to-view (reference shows the clicked image, tsne_utils.py:363)
const b64=THUMBS[path];
if(b64){img.src='data:image/jpeg;base64,'+b64;img.style.display='block';}
else{img.style.display='none';}
pvcap.textContent=path+'  ['+(d.classes[d.labels[i]]||'Unknown')+']';
navigator.clipboard&&navigator.clipboard.writeText(path);};
cv.ondblclick=()=>{if(!polyMode||poly.length<3)return;
const d=DATA[sel.value],ins=[],outs=[];
pts.forEach(([x,y,i])=>{(inside(x,y)?ins:outs).push(d.paths[i]||String(i));});
const blob=new Blob([JSON.stringify({inside:ins,outside:outs},null,2)],
{type:'application/json'});
const a=document.createElement('a');a.href=URL.createObjectURL(blob);
a.download='inside_polygon_'+sel.value.replace(/ /g,'_')+'.json';a.click();
polyMode=false;poly=[];draw();};
sel.onchange=()=>{buildLegend();draw();};
buildLegend();draw();
"""
